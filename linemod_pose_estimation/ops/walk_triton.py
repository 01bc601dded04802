"""cv::linemod's level-0 refinement walk as one Pallas kernel on the
Triton route (``backend="triton"``).

The walk scores each coarse candidate at a 16x16 grid of stride-T
placements: placement (r, c) of candidate k sums, over the template's live
level-0 features f, the response at pixel ((gy0+r)*T + fy_f,
(gx0+c)*T + fx_f) of orientation channel ori_f (ops.match
.refine_candidates_opencv_batched has the full derivation).  The plain XLA
form (ops.match.walk_scores_xla) runs it as a scan of Fmax dependent
steps, each reading and writing the whole (B*K, 16, 16) accumulator.

Here one program owns one (frame, candidate slot): its 16x16 accumulator
stays in registers, and it loops over the candidate's live features, each
iteration gathering one strided 16x16 window of the uint8 response map.
Programs are numbered frame-major, so the programs in flight share one
frame's maps in L2.  Slots past the frame's valid prefix (`nf` 0) write
exact zeros, as the XLA form does.

The kernel walks features [0, nf): callers must hand it banks whose live
feature slots are a prefix (ops.match guards that in-graph).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

WIN = 16  # cv::linemod's fixed 16x16 local similarity map


def pad_responses(R0: jnp.ndarray, T: int, E0: int) -> jnp.ndarray:
    """Zero-pad (B, C, H, W) responses bottom/right so every placement of
    every feature (offsets in [0, E0]) reads in bounds; padded H and W are
    multiples of T.  Shared by both walk forms, so they read the same
    zeros past the frame edge."""
    B, C, H, W = R0.shape
    pad = ((E0 + WIN * T) // T + 1) * T
    pad_h = pad + (-(H + pad)) % T
    pad_w = pad + (-(W + pad)) % T
    return jnp.pad(R0, [(0, 0), (0, 0), (0, pad_h), (0, pad_w)])


def _walk_kernel(meta_ref, off_ref, r_ref, o_ref, *, T: int, Wp: int):
    i = pl.program_id(0)
    b = meta_ref[i, 0]  # frame
    base = meta_ref[i, 1]  # flat offset of placement (0, 0)
    nf = meta_ref[i, 2]  # features to walk (0: skipped slot)
    r = jax.lax.broadcasted_iota(jnp.int32, (WIN, WIN), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (WIN, WIN), 1)
    grid = r * (T * Wp) + c * T

    def body(f, acc):
        idx = base + off_ref[i, f] + grid
        return acc + r_ref[b, idx].astype(jnp.int32)

    o_ref[...] = jax.lax.fori_loop(
        0, nf, body, jnp.zeros((WIN, WIN), jnp.int32))


@partial(jax.jit, static_argnames=("T", "E0", "interpret"))
def walk_scores_triton(
    R0: jnp.ndarray,  # (B, C, H, W) uint8 responses
    frame: jnp.ndarray,  # (BK,) int32 frame of each candidate slot
    oris: jnp.ndarray,  # (BK, Fmax) int32 orientation channel per feature
    fy: jnp.ndarray,  # (BK, Fmax) int32 feature rows, clipped to [0, E0]
    fx: jnp.ndarray,  # (BK, Fmax) int32 feature columns, clipped to [0, E0]
    nf: jnp.ndarray,  # (BK,) int32 features to walk (0 = skipped slot)
    gy0: jnp.ndarray,  # (BK,) int32 grid row of placement (0, 0)
    gx0: jnp.ndarray,  # (BK,) int32 grid column of placement (0, 0)
    T: int,
    E0: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """Raw walk scores (BK, 256) int32, row-major over the 16x16
    placements — equal to ops.match.walk_scores_xla on contiguous banks."""
    Rp = pad_responses(R0, T, E0)
    B, C, Hp, Wp = Rp.shape
    BK = frame.shape[0]
    Rf = Rp.reshape(B, C * Hp * Wp)
    off = (oris * Hp + fy) * Wp + fx
    # The walk's own clamps keep gy0, gx0 >= 0; the clamp here only keeps
    # every read inside the buffer whatever the caller passes.
    base = (jnp.maximum(gy0, 0) * T) * Wp + jnp.maximum(gx0, 0) * T
    meta = jnp.stack([frame, base, nf], axis=1).astype(jnp.int32)
    out = pl.pallas_call(
        partial(_walk_kernel, T=T, Wp=Wp),
        out_shape=jax.ShapeDtypeStruct((BK, WIN, WIN), jnp.int32),
        grid=(BK,),
        in_specs=[pl.BlockSpec(), pl.BlockSpec(), pl.BlockSpec()],
        out_specs=pl.BlockSpec((None, WIN, WIN), lambda i: (i, 0, 0)),
        backend="triton",
        # 2 warps for a 16x16 block: 0.76 ms vs 0.87 ms with 1 warp and
        # 0.76 ms with 4 at B=32, K=128 on an H100 (PERF.md).
        compiler_params=plgpu.CompilerParams(num_warps=2, num_stages=1),
        interpret=interpret,
        name="linemod_walk",
    )(meta, off.astype(jnp.int32), Rf)
    return out.reshape(BK, WIN * WIN)
