"""Batched sliding-window template scoring — the back half of the
cv::linemod engine (SURVEY.md section 2.2 E1) as batched device compute.

Where OpenCV walks linearized memories with SSE u8 adds per template, we
batch the whole template bank into one device computation per frame:

  coarse level (pyramid top, stride T) — the PRODUCTION path:
     response maps -> linearized planes L[Hc+Kc, Wc+Kc, C*T*T] (channel x
     subcell axis last) -> the patch matrix P[(B*)Hc*Wc, C*T*T*Kc*Kc]
     assembles as contiguous slice+concat -> ONE int8 x int8 -> int32 GEMM
     against the bank's one-hot weights (coarse_scores_gemm_flat[_batched]).
     Scores stay POSITION-MAJOR (positions, N), the GEMM's natural layout;
     select_candidates_flat does the fused similarity convert + validity
     mask + top-k.  (coarse_scores, the gather-based lax.scan formulation,
     remains as the bit-identical reference implementation the fast paths
     are equality-tested against; coarse_scores_conv is the big-kernel conv
     twin.)

  fine level (pyramid bottom, stride 1):
     cv::linemod's exact 16x16 stride-T0 refinement walk around each
     coarse candidate (refine_candidates_opencv_batched): an XLA scan
     (walk_scores_xla) or one Pallas-Triton kernel (ops.walk_triton), as
     ops.backend decides.  The dense-window twins (refine_candidates,
     refine_candidates_slices, refine_candidates_conv) remain as reference
     implementations.

Modalities (ColorGradient + DepthNormal) are fused before scoring: their
response maps concatenate channel-wise (C = 8 * num_modalities) and their
feature lists merge with globally-offset orientation indices, so one GEMM
scores both — similarity(%) = 100 * raw / (4 * total_features), identical
to cv::linemod::Detector::match which sums similarities across modalities
before normalizing (parity vs the real engine: tests/test_oracle_parity).

The template axis is the sharding axis for multi-chip operation
(parallel/sharded_match.py): each device scores its shard of the bank and
top-k results merge over ICI; the frame-row axis shards for the
context-parallel layout (make_row_sharded_matcher).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from . import backend
from . import features as F
from . import walk_triton


def correct_quotient(a: jnp.ndarray, b: jnp.ndarray,
                     q0: jnp.ndarray) -> jnp.ndarray:
    """The correctly rounded float32 a / b, given an approximation q0 within
    two ulps of it, for integer-valued float32 0 <= a < 2^24 and
    1 <= b < 2^12.  Each candidate c near q0 is split into two 12-bit
    halves, so the residual a - c * b is computed without rounding (with or
    without fused multiply-adds); the smallest residual wins, ties to the
    even significand."""
    a, b, q0 = jnp.broadcast_arrays(a, b, q0)
    down = jnp.nextafter(q0, -jnp.inf)
    up = jnp.nextafter(q0, jnp.inf)
    c = jnp.stack([jnp.nextafter(down, -jnp.inf), down, q0, up,
                   jnp.nextafter(up, jnp.inf)])
    bits = jax.lax.bitcast_convert_type(c, jnp.uint32)
    ch = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFF000), jnp.float32)
    cl = c - ch
    r = jnp.abs((a - ch * b) - cl * b)
    score = jnp.where(r == jnp.min(r, axis=0), (bits & 1).astype(jnp.int32), 2)
    q = jnp.take_along_axis(c, jnp.argmin(score, axis=0)[None], axis=0)[0]
    # a == 0: the candidates next to 0 are subnormals, which a backend that
    # flushes them to zero would score as exact too.
    return jnp.where(a == 0, jnp.float32(0), q)


def exact_quotient(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """IEEE float32 a / b for integer-valued a, b in correct_quotient's range,
    bit-equal on every backend: a GPU's float32 divide may be an ulp off."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return correct_quotient(a, b, a / b)


def similarity(raw: jnp.ndarray, count: jnp.ndarray) -> jnp.ndarray:
    """cv::linemod's similarity percent 100 * raw / (4 * count), rounded
    once, identically on every backend (raw <= 4 * count < 2^14)."""
    return exact_quotient(25 * raw.astype(jnp.int32), jnp.maximum(count, 1))


def similarity_scale(count: jnp.ndarray) -> jnp.ndarray:
    """100 / (4 * count) as float32, identically on every backend (the
    per-template factor the candidate selects multiply raw scores by)."""
    return exact_quotient(25, jnp.maximum(count, 1))


class LevelFeatures(NamedTuple):
    """Padded per-level feature set for a bank of N templates.

    offsets: (N, Fmax, 2) int32 — (dy, dx) pixel offsets inside the template
    oris:    (N, Fmax)    int32 — orientation channel (globally indexed when
                                   modalities are merged: mod*8 + bin)
    live:    (N, Fmax)    bool  — which slots hold real features
    count:   (N,)         int32 — total live features (for normalization)
    size:    (N, 2)       int32 — template (h, w) at this level
    """

    offsets: jnp.ndarray
    oris: jnp.ndarray
    live: jnp.ndarray
    count: jnp.ndarray
    size: jnp.ndarray


def merge_modalities(
    feats: Sequence[LevelFeatures], response_maps: Sequence[jnp.ndarray]
) -> tuple[LevelFeatures, jnp.ndarray]:
    """Concatenate modalities into one feature set + one response stack.

    Each modality m's orientation indices shift by 8*m to address its slice
    of the channel-concatenated response maps.
    """
    assert len(feats) == len(response_maps) >= 1
    if len(feats) == 1:
        return feats[0], response_maps[0]
    offs = jnp.concatenate([f.offsets for f in feats], axis=1)
    oris = jnp.concatenate(
        [f.oris + 8 * m for m, f in enumerate(feats)], axis=1
    )
    live = jnp.concatenate([f.live for f in feats], axis=1)
    # Compact live slots to the FRONT (stable): cv::linemod stores up to
    # 63 features per modality in 64-slot blocks, so the raw concat leaves
    # dead padding slots interspersed (e.g. slot 63 dead, slot 126 live at
    # nf = 126) — and the Triton walk kernel walks features f < nf, which
    # would mis-score non-contiguous live slots (a few raw units per
    # candidate on the real dual-modality bank).  Every
    # consumer is order-invariant (weights are scatter-adds, the walk is
    # a sum), so compaction is free exactness insurance.
    offs, oris, live = _compact_live_slots(offs, oris, live)
    count = sum(f.count for f in feats)
    size = jnp.max(jnp.stack([f.size for f in feats]), axis=0)
    R = jnp.concatenate(list(response_maps), axis=0)
    return LevelFeatures(offs, oris, live, count, size), R


def linearize_responses_lanes(R: jnp.ndarray, T: int, max_cell_extent: int) -> jnp.ndarray:
    """(C, H, W) response maps -> (Hc + Kc, Wc + Kc, C*T*T) planes with the
    channel x subcell axis LAST, so the GEMM patch matrix assembles as
    contiguous slice+concat instead of a 4-D transpose."""
    C, H, W = R.shape
    Hc, Wc = H // T, W // T
    Kc = max_cell_extent
    Rc = R[:, : Hc * T, : Wc * T].reshape(C, Hc, T, Wc, T)
    L = Rc.transpose(1, 3, 0, 2, 4).reshape(Hc, Wc, C * T * T)
    return jnp.pad(L, [(0, Kc), (0, Kc), (0, 0)])


def _gemm_patches(R: jnp.ndarray, T: int, Kc: int) -> jnp.ndarray:
    """(Hc*Wc, C*T*T*Kc*Kc) int8 patch matrix; column order matches
    build_gemm_weights' row index ((qy*Kc + qx)*C + ori)*T*T + sub."""
    C, H, W = R.shape
    Hc, Wc = H // T, W // T
    L = linearize_responses_lanes(R, T, Kc)
    blocks = [
        L[qy : qy + Hc, qx : qx + Wc, :]
        for qy in range(Kc)
        for qx in range(Kc)
    ]
    return jnp.concatenate(blocks, axis=-1).reshape(Hc * Wc, -1).astype(jnp.int8)


def linearize_responses(R: jnp.ndarray, T: int, max_cell_extent: int) -> jnp.ndarray:
    """(C, H, W) response maps -> (C*T*T, Hc + Kc, Wc + Kc) planes.

    L[c*T*T + ry*T + rx, i, j] = R[c, i*T + ry, j*T + rx]; bottom/right
    zero-padded by Kc cells so any feature cell-shift reads in-bounds.
    """
    C, H, W = R.shape
    Hc, Wc = H // T, W // T
    Kc = max_cell_extent
    Rc = R[:, : Hc * T, : Wc * T].reshape(C, Hc, T, Wc, T)
    L = Rc.transpose(0, 2, 4, 1, 3).reshape(C * T * T, Hc, Wc)
    return jnp.pad(L, [(0, 0), (0, Kc), (0, Kc)])


@partial(jax.jit, static_argnames=("T", "max_cell_extent"))
def coarse_scores(
    R: jnp.ndarray,
    feats: LevelFeatures,
    T: int,
    max_cell_extent: int,
) -> jnp.ndarray:
    """Raw scores (N, Hc, Wc) int32 of every template at every T-strided
    window position."""
    L = linearize_responses(R, T, max_cell_extent)
    C, H, W = R.shape
    Hc, Wc = H // T, W // T
    N, Fmax = feats.oris.shape

    dy = feats.offsets[..., 0]
    dx = feats.offsets[..., 1]
    chan = feats.oris * (T * T) + (dy % T) * T + (dx % T)  # (N, Fmax)
    qy = dy // T
    qx = dx // T

    def slice_one(c, y, x):
        return jax.lax.dynamic_slice(L, (c, y, x), (1, Hc, Wc))[0]

    def body(acc, fidx):
        vals = jax.vmap(
            lambda c, y, x, m: jnp.where(m, slice_one(c, y, x).astype(jnp.int32), 0)
        )(chan[:, fidx], qy[:, fidx], qx[:, fidx], feats.live[:, fidx])
        return acc + vals, None

    acc0 = jnp.zeros((N, Hc, Wc), jnp.int32)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(Fmax, dtype=jnp.int32))
    return acc


# ---------------------------------------------------------------------------
# One-hot dense-conv scoring (numerically identical to coarse_scores, which
# remains the gather-based reference).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("C", "E"))
def build_dense_weights(feats: LevelFeatures, C: int, E: int) -> jnp.ndarray:
    """One-hot conv weights (N, C, E, E) int8: W[n, ori, dy, dx] = 1 per
    feature.  The whole bank becomes a single convolution filter bank —
    scoring all templates at all window positions is then one conv
    (built once per bank; E = max template extent, multiple of 8)."""
    N, Fmax = feats.oris.shape
    flat = jnp.zeros((N, C * E * E), jnp.int8)
    dy = jnp.clip(feats.offsets[..., 0], 0, E - 1)
    dx = jnp.clip(feats.offsets[..., 1], 0, E - 1)
    idx = feats.oris * (E * E) + dy * E + dx
    ones = jnp.where(feats.live, jnp.int8(1), jnp.int8(0))
    # .add, not .max: duplicate (ori, dy, dx) features must count with
    # multiplicity to match the gather-based scorer exactly.
    flat = flat.at[jnp.arange(N)[:, None], idx].add(ones)
    return flat.reshape(N, C, E, E)


@partial(jax.jit, static_argnames=("T",))
def coarse_scores_conv(R: jnp.ndarray, W_dense: jnp.ndarray, T: int) -> jnp.ndarray:
    """Raw scores (N, Hc, Wc) int32 via one stride-T convolution.

    R zero-padded by E-T on the bottom/right so the output grid matches
    coarse_scores' floor(H/T) x floor(W/T); positions where a template
    overhangs read zeros and are masked by position_validity downstream.
    """
    C, H, W = R.shape
    N, Cw, E, _ = W_dense.shape
    assert Cw == C
    Hc, Wc = H // T, W // T
    pad_h = (Hc - 1) * T + E - H
    pad_w = (Wc - 1) * T + E - W
    Rp = jnp.pad(R, [(0, 0), (0, max(pad_h, 0)), (0, max(pad_w, 0))])
    out = jax.lax.conv_general_dilated(
        Rp[None].astype(jnp.int8),
        W_dense,
        window_strides=(T, T),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.int32,
    )[0]
    return out[:, :Hc, :Wc]


@partial(jax.jit, static_argnames=("C", "T", "Kc"))
def build_gemm_weights(feats: LevelFeatures, C: int, T: int, Kc: int) -> jnp.ndarray:
    """One-hot GEMM weights (C*T*T*Kc*Kc, N) int8 for coarse_scores_gemm.

    Row index = ((qy*Kc + qx) * C + ori) * T*T + ry*T + rx for a feature at
    offset (dy, dx) = (qy*T + ry, qx*T + rx).  Built once per bank.
    """
    N, Fmax = feats.oris.shape
    dy = feats.offsets[..., 0]
    dx = feats.offsets[..., 1]
    qy = jnp.clip(dy // T, 0, Kc - 1)
    qx = jnp.clip(dx // T, 0, Kc - 1)
    row = ((qy * Kc + qx) * C + feats.oris) * (T * T) + (dy % T) * T + (dx % T)
    Wt = jnp.zeros((N, C * T * T * Kc * Kc), jnp.int8)
    Wt = Wt.at[jnp.arange(N)[:, None], row].add(
        jnp.where(feats.live, jnp.int8(1), jnp.int8(0))
    )
    return Wt.T  # (K_dim, N)


@partial(jax.jit, static_argnames=("T", "Kc"))
def coarse_scores_gemm_flat(
    R: jnp.ndarray, W_gemm: jnp.ndarray, T: int, Kc: int
) -> jnp.ndarray:
    """Raw scores (Hc*Wc, N) int32 as ONE GEMM — POSITION-MAJOR.

    The im2col is free: the linearized planes L[C*T*T, Hc+Kc, Wc+Kc] admit
    every cell shift (qy, qx) as a STATIC slice, so the patch matrix
    P[(Hc*Wc), C*T*T*Kc*Kc] is a stack of Kc^2 static views — XLA compiles
    this orders of magnitude faster than the equivalent big-kernel conv,
    and the contraction is a plain int8 x int8 -> int32 matmul.

    The output keeps the GEMM's natural (positions, N) layout, with the
    long template axis last for every downstream elementwise pass.
    """
    P = _gemm_patches(R, T, Kc)
    return jax.lax.dot_general(
        P,
        W_gemm,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (Hc*Wc, N)


@partial(jax.jit, static_argnames=("T", "Kc"))
def coarse_scores_gemm_flat_batched(
    Rb: jnp.ndarray, W_gemm: jnp.ndarray, T: int, Kc: int
) -> jnp.ndarray:
    """(B, C, H, W) response batch -> (B, Hc*Wc, N) int32 via ONE GEMM.

    The frame batch folds into the GEMM's M dimension (B*Hc*Wc rows) —
    one large contraction in place of B separate M=Hc*Wc matmuls."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    P = jax.vmap(lambda R: _gemm_patches(R, T, Kc))(Rb).reshape(B * Hc * Wc, -1)
    raw = jax.lax.dot_general(
        P,
        W_gemm,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return raw.reshape(B, Hc * Wc, -1)


# ---------------------------------------------------------------------------
# Exact hierarchical pruning (the exhaustive GEMM scores every template at
# every position; the bounds below skip most of that work exactly).
#
# Responses are graded 0..4, so for any window position p and template n the
# true raw score   s(p, n) = sum_f R[ori_f, p + off_f]   is bounded above by
# replacing each feature's read with the MAX response inside its TxT cell:
#
#   s(p, n) <= UB(p, n) = sum_f maxpool_TxT(R)[ori_f, cell_f + p]
#            = (cheap GEMM)  P_ub[p, :] . W_cell[n, :]
#
# where W_cell counts features per (cell, orientation) bin.  The cheap GEMM's
# contraction axis is C*Kc*Kc = 576 instead of C*T*T*Kc*Kc = 36,864 — 64x
# less arithmetic — and any template whose UB stays below the selection
# threshold at EVERY valid position provably cannot produce a candidate, so
# the expensive exact GEMM runs only over the compacted survivor templates.
# The bound is exact-safe: the surviving-template exact scores equal the
# exhaustive path's bit-for-bit (tests/test_prune.py), and the survivor set
# always contains every template with any position at or above threshold.
#
# NOTE this is deliberately NOT the "score a feature subset" bound
# (s_k + 4*(nf-k)): the one-hot contraction is DENSE — scoring fewer
# features per template does not shrink the GEMM at all.  Shrinking the
# contraction axis (subcell -> cell granularity) is what buys the 64x.
# ---------------------------------------------------------------------------


def _ub_patches(R: jnp.ndarray, T: int, Kc: int) -> jnp.ndarray:
    """(C, H, W) responses -> (Hc*Wc, Kc*Kc*C) int8 cell-max patch matrix;
    column order matches build_cell_weights' bin index (qy*Kc + qx)*C + c."""
    C, H, W = R.shape
    Hc, Wc = H // T, W // T
    Rm = R[:, : Hc * T, : Wc * T].reshape(C, Hc, T, Wc, T).max(axis=(2, 4))
    M = jnp.pad(Rm.transpose(1, 2, 0), [(0, Kc), (0, Kc), (0, 0)])
    blocks = [
        M[qy : qy + Hc, qx : qx + Wc, :] for qy in range(Kc) for qx in range(Kc)
    ]
    return jnp.concatenate(blocks, axis=-1).reshape(Hc * Wc, -1).astype(jnp.int8)


@partial(jax.jit, static_argnames=("C", "T", "Kc"))
def build_cell_weights(feats: LevelFeatures, C: int, T: int, Kc: int) -> jnp.ndarray:
    """(N, C*Kc*Kc) int8 feature counts per (cell, orientation) bin — the
    upper-bound GEMM's weights (built once per bank; counts <= T*T < 128)."""
    N, Fmax = feats.oris.shape
    qy = jnp.clip(feats.offsets[..., 0] // T, 0, Kc - 1)
    qx = jnp.clip(feats.offsets[..., 1] // T, 0, Kc - 1)
    row = (qy * Kc + qx) * C + feats.oris
    Wc_ = jnp.zeros((N, C * Kc * Kc), jnp.int8)
    return Wc_.at[jnp.arange(N)[:, None], row].add(
        jnp.where(feats.live, jnp.int8(1), jnp.int8(0))
    )


class PruneResult(NamedTuple):
    """Survivor-template compaction of a bank for one frame batch.

    idx:      (n_cap,) int32 — global template ids of the survivors (top
              n_cap by upper-bound score when over capacity)
    keep:     (n_cap,) bool  — which slots hold real survivors
    n_survivors: ()    int32 — true survivor count (before capping)
    overflow: ()       bool  — n_survivors > n_cap: the pruned pass kept the
              n_cap highest-bound templates and exactness is no longer
              guaranteed for the remainder (callers may re-run exhaustive)
    """

    idx: jnp.ndarray
    keep: jnp.ndarray
    n_survivors: jnp.ndarray
    overflow: jnp.ndarray


@partial(jax.jit, static_argnames=("T", "Kc", "n_cap"))
def prune_templates_batched(
    Rb: jnp.ndarray,
    W_cell: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    T: int,
    Kc: int,
    n_cap: int,
) -> PruneResult:
    """Upper-bound pass over a (B, C, H, W) response batch: returns the
    compacted set of templates whose UB similarity reaches `threshold` at
    any valid position of any frame (a superset of every template that can
    appear as a candidate at that threshold)."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    N = W_cell.shape[0]
    P_ub = jax.vmap(lambda R: _ub_patches(R, T, Kc))(Rb).reshape(B * Hc * Wc, -1)
    ub = jax.lax.dot_general(
        P_ub,
        W_cell,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (B*Hc*Wc, N)
    scale = similarity_scale(total_features)
    sim_ub = ub.reshape(B, Hc * Wc, N).astype(jnp.float32) * scale[None, None, :]
    sim_ub = jnp.where(vpos_flat[None], sim_ub, -1.0)
    t_score = jnp.max(sim_ub, axis=(0, 1))  # (N,)
    # Small slack: float rounding must never flip a borderline UB below an
    # exact score at threshold (slack only ADDS survivors — still exact).
    eligible = t_score >= threshold - 1e-3
    n_surv = jnp.sum(eligible.astype(jnp.int32))
    k = min(n_cap, N)
    vals, idx = jax.lax.top_k(jnp.where(eligible, t_score, -jnp.inf), k)
    return PruneResult(
        idx.astype(jnp.int32), vals > -jnp.inf, n_surv, n_surv > k
    )


class PrunePlan(NamedTuple):
    """Two-axis survivor compaction: positions are the SPARSE axis on real
    scenes (measured: ~1% of coarse positions hold every above-threshold
    pair, while ~16-60% of templates do — the bank is views of the same
    object, so any visible object lights up many templates but few anchor
    cells).  Position pruning is also per-frame, so it does not dilute with
    batch size the way the batch-union template axis does.

    t_idx/t_keep: (n_cap,) — survivor templates (global ids), batch-union
    p_idx/p_keep: (B, m_cap) — survivor flat positions per frame
    n_survivors:  ()   int32 — true template-survivor count
    m_survivors:  (B,) int32 — true position-survivor count per frame
    overflow:     ()   bool  — either axis over capacity (kept the highest-
                  bound entries; exactness no longer guaranteed)
    """

    t_idx: jnp.ndarray
    t_keep: jnp.ndarray
    p_idx: jnp.ndarray
    p_keep: jnp.ndarray
    n_survivors: jnp.ndarray
    m_survivors: jnp.ndarray
    overflow: jnp.ndarray


@partial(jax.jit, static_argnames=("T", "Kc", "n_cap", "m_cap"))
def prune_plan_batched(
    Rb: jnp.ndarray,
    W_cell: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    T: int,
    Kc: int,
    n_cap: int,
    m_cap: int,
) -> PrunePlan:
    """One cheap upper-bound GEMM -> survivor compaction on BOTH axes."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    N = W_cell.shape[0]
    P_ub = jax.vmap(lambda R: _ub_patches(R, T, Kc))(Rb).reshape(B * Hc * Wc, -1)
    ub = jax.lax.dot_general(
        P_ub, W_cell,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    scale = similarity_scale(total_features)
    sim_ub = ub.reshape(B, Hc * Wc, N).astype(jnp.float32) * scale[None, None, :]
    sim_ub = jnp.where(vpos_flat[None], sim_ub, -1.0)
    thr = threshold - 1e-3  # float slack only ADDS survivors — still exact

    t_score = jnp.max(sim_ub, axis=(0, 1))  # (N,)
    t_elig = t_score >= thr
    n_surv = jnp.sum(t_elig.astype(jnp.int32))
    kn = min(n_cap, N)
    tv, t_idx = jax.lax.top_k(jnp.where(t_elig, t_score, -jnp.inf), kn)

    p_score = jnp.max(sim_ub, axis=2)  # (B, P)
    p_elig = p_score >= thr
    m_surv = jnp.sum(p_elig.astype(jnp.int32), axis=1)  # (B,)
    km = min(m_cap, Hc * Wc)
    pv, p_idx = jax.lax.top_k(jnp.where(p_elig, p_score, -jnp.inf), km)

    overflow = (n_surv > kn) | jnp.any(m_surv > km)
    return PrunePlan(
        t_idx.astype(jnp.int32), tv > -jnp.inf,
        p_idx.astype(jnp.int32), pv > -jnp.inf,
        n_surv, m_surv, overflow,
    )


@partial(jax.jit, static_argnames=("T", "Kc"))
def coarse_scores_gemm_flat_batched_sub2(
    Rb: jnp.ndarray,
    W_rows: jnp.ndarray,
    t_idx: jnp.ndarray,
    p_idx: jnp.ndarray,
    T: int,
    Kc: int,
) -> jnp.ndarray:
    """Exact coarse GEMM over the survivor grid only: (B, m_cap, n_cap).

    The patch matrix still assembles in full (bandwidth-bound), but the
    expensive contraction shrinks to m_cap x n_cap — ~20-50x less GEMM
    arithmetic on bin-picking scenes."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    W_sub = W_rows[t_idx]  # (n_cap, K_dim)
    P = jax.vmap(lambda R: _gemm_patches(R, T, Kc))(Rb)  # (B, P, K)
    P_sub = jax.vmap(lambda Pf, pi: Pf[pi])(P, p_idx)  # (B, m_cap, K)
    m_cap = p_idx.shape[1]
    raw = jax.lax.dot_general(
        P_sub.reshape(B * m_cap, -1), W_sub,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return raw.reshape(B, m_cap, -1)


@partial(jax.jit, static_argnames=("top_k", "Wc"))
def select_candidates_flat_sub2(
    raw_sub: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    t_idx: jnp.ndarray,
    t_keep: jnp.ndarray,
    p_idx: jnp.ndarray,
    p_keep: jnp.ndarray,
    threshold: float,
    top_k: int,
    Wc: int,
) -> CoarseMatches:
    """Candidate selection over the (m_cap, n_cap) survivor grid of ONE
    frame; ids map back through t_idx/p_idx.  The valid (>= threshold)
    candidate set matches the exhaustive path's exactly (no overflow)."""
    m_cap, n_cap = raw_sub.shape
    scale = similarity_scale(total_features[t_idx])
    vpos_sub = vpos_flat[p_idx][:, t_idx] & t_keep[None, :] & p_keep[:, None]
    sim = jnp.where(vpos_sub, raw_sub.astype(jnp.float32) * scale[None, :], -1.0)
    flat = sim.reshape(-1)
    k = min(top_k, flat.shape[0])
    vals, fidx = jax.lax.top_k(flat, k)
    t_sub = fidx % n_cap
    pos = p_idx[fidx // n_cap]
    return CoarseMatches(
        t_idx[t_sub].astype(jnp.int32),
        (pos // Wc).astype(jnp.int32),
        (pos % Wc).astype(jnp.int32),
        vals,
        vals >= threshold,
    )


def int_score_threshold(threshold: float, total_features: jnp.ndarray) -> jnp.ndarray:
    """Per-template integer raw-score threshold t_int with
    ub >= t_int  <=>  sim_ub >= threshold (sim = 100 * raw / (4 * nf),
    raw integral).  The 1e-3/1e-4 slacks absorb f32 rounding and can only
    ADD survivors, so every pruning stage sharing this rule keeps the
    exact superset invariant — ALL bound stages must use THIS function."""
    return jnp.ceil(
        (threshold - 1e-3) * 0.04 * total_features.astype(jnp.float32) - 1e-4
    )


@partial(jax.jit, static_argnames=("T", "Kc", "m_cap"))
def prune_positions_batched(
    Rb: jnp.ndarray,
    W_cell: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    T: int,
    Kc: int,
    m_cap: int,
) -> PrunePlan:
    """Position-axis-only pruning (the axis that actually prunes on real
    banks): one cell-max upper-bound GEMM -> per-frame survivor positions.

    Measured on the reference-scale trained bank over bin-picking scenes:
    ~1-5% of coarse positions hold every above-threshold (position,
    template) pair, while the batch-union TEMPLATE axis keeps 60-90% of a
    one-object bank (its views are self-similar, and the union dilutes
    with batch size).  Dropping the template axis keeps the exact GEMM's
    weight matrix STATIC — no (n_cap, K) gather, whose memory traffic
    dominated the two-axis sub-GEMM — so the exact pass shrinks to
    (B*m_cap, K) x (K, N) with the same W as the exhaustive path.

    Returns a PrunePlan whose template axis is the identity (t_idx =
    arange, t_keep = all); exactness: every (position, template) with
    exact score >= threshold survives, because the cell-max bound
    dominates the exact response at every feature.

    The eligibility test runs in the INT domain: instead of materializing
    the (B, P, N) f32 similarity (3 extra full passes over the biggest
    tensor in the pass), each template gets an int32 raw-score threshold
    t_int[n] = ceil(thr * 4 * nf / 100) and the reduction is a masked
    int max of (ub - t_int).  The ceil carries a -1e-4 slack so float
    rounding can only ADD survivors — the set stays a superset of every
    above-threshold template, i.e. still exact."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    N = W_cell.shape[0]
    p_score = position_margins_batched(
        Rb, W_cell, total_features, vpos_flat, threshold, T, Kc
    )
    p_elig = p_score >= 0
    m_surv = jnp.sum(p_elig.astype(jnp.int32), axis=1)
    km = min(m_cap, Hc * Wc)
    pv, p_idx = jax.lax.top_k(jnp.where(p_elig, p_score, -(2**30)), km)

    return PrunePlan(
        jnp.arange(N, dtype=jnp.int32), jnp.ones((N,), bool),
        p_idx.astype(jnp.int32), pv > -(2**30),
        jnp.asarray(N, jnp.int32), m_surv, jnp.any(m_surv > km),
    )


@partial(jax.jit, static_argnames=("T", "Kc"))
def position_margins_batched(
    Rb: jnp.ndarray,
    W_cell: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    T: int,
    Kc: int,
) -> jnp.ndarray:
    """The shared bound pass of the position-pruning paths: (B, P) int32
    margins max_n(ub(p, n) - t_int[n]) with invalid positions at a deep
    sentinel — a position can hold an above-threshold match iff its margin
    is >= 0 (the cell-max bound dominates the exact response at every
    feature; slack rule in int_score_threshold).  Used by both the
    per-frame-cap planner (prune_positions_batched) and the batch-shared
    pool planner (pool_plan_from_margins)."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    N = W_cell.shape[0]
    P_ub = jax.vmap(lambda R: _ub_patches(R, T, Kc))(Rb).reshape(B * Hc * Wc, -1)
    t_int = int_score_threshold(threshold, total_features).astype(jnp.int32)
    # int32 accumulation: an s8 x s8 -> s16 dot has no fast route on the
    # GPU (measured ~400x slower than s32 on the H100, PERF.md) nor on the
    # CPU, and int32 cannot wrap for any feature count.
    ub = jax.lax.dot_general(
        P_ub, W_cell,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(B, Hc * Wc, N)
    margin = jnp.where(vpos_flat[None], ub - t_int[None, None, :], -(2**30))
    return jnp.max(margin, axis=2)  # (B, P)


@partial(jax.jit, static_argnames=("Kc", "Wc"))
def gather_cell_patches_onehot(
    L4: jnp.ndarray,
    p_idx: jnp.ndarray,
    Kc: int,
    Wc: int,
) -> jnp.ndarray:
    """Survivor-position patch rows as TWO one-hot int8 contractions.

    L4: (B, Hc + Kc, Wc + Kc, CTT) int8 linearized cell tensor; p_idx:
    (B, m) flat survivor cells.  Returns (B, m, Kc * Kc * CTT) int8 ==
    L4[b, py+qy, px+qx, :] stacked in (qy, qx) order (the same rows
    assemble_survivor_patches gathers from the linearized-cell tensor).

    The 2-D window gather is separable: select the Kc columns per
    survivor by a one-hot (Wx, Kc) matmul (the 1 KB-row axis where
    XLA's generic gather is pathological), then the Kc rows by a one-hot
    (Hy, Kc) matmul.  Responses are <= 4 so int8 x int8 -> int32 is
    exact, and the intermediates stay int8."""
    B, Hy, Wx, CTT = L4.shape
    m = p_idx.shape[1]
    py = (p_idx // Wc).astype(jnp.int32)
    px = (p_idx % Wc).astype(jnp.int32)
    x = jnp.arange(Wx, dtype=jnp.int32)
    y = jnp.arange(Hy, dtype=jnp.int32)
    q = jnp.arange(Kc, dtype=jnp.int32)
    Csel = (
        x[None, None, :, None] == (px[..., None, None] + q[None, None, None, :])
    ).astype(jnp.int8)  # (B, m, Wx, Kc)
    Rsel = (
        y[None, None, :, None] == (py[..., None, None] + q[None, None, None, :])
    ).astype(jnp.int8)  # (B, m, Hy, Kc)
    s1 = jnp.einsum(
        "byxt,bjxr->bjyrt", L4, Csel, preferred_element_type=jnp.int32
    ).astype(jnp.int8)  # (B, m, Hy, Kc, CTT)
    s2 = jnp.einsum(
        "bjyrt,bjyq->bjqrt", s1, Rsel, preferred_element_type=jnp.int32
    ).astype(jnp.int8)  # (B, m, Kc, Kc, CTT) in (qy, qx) order
    return s2.reshape(B, m, Kc * Kc * CTT)


@partial(jax.jit, static_argnames=("T", "Kc"))
def assemble_survivor_patches(
    Rb: jnp.ndarray,
    p_idx: jnp.ndarray,
    T: int,
    Kc: int,
) -> jnp.ndarray:
    """(B, C, H, W) responses + (B, m) survivor cells -> (B, m, K) int8
    patch rows for the exact survivor GEMM (column order matches
    build_gemm_weights), gathered by XLA as rows of the linearized-cell
    tensor."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    m_cap = p_idx.shape[1]
    L = jax.vmap(lambda R: linearize_responses_lanes(R, T, Kc))(Rb)
    CTT = C * T * T
    Lf = L.reshape(B, (Hc + Kc) * (Wc + Kc), CTT).astype(jnp.int8)
    py, px = p_idx // Wc, p_idx % Wc
    q = jnp.arange(Kc, dtype=jnp.int32)
    cell = (
        (py[..., None, None] + q[None, None, :, None]) * (Wc + Kc)
        + (px[..., None, None] + q[None, None, None, :])
    ).reshape(B, m_cap, Kc * Kc)
    P_sub = jax.vmap(lambda Lb, cb: Lb[cb])(Lf, cell)
    return P_sub.reshape(B, m_cap, Kc * Kc * CTT)


@partial(jax.jit, static_argnames=("T", "Kc"))
def coarse_scores_gemm_flat_batched_pos(
    Rb: jnp.ndarray,
    W_gemm: jnp.ndarray,
    p_idx: jnp.ndarray,
    T: int,
    Kc: int,
) -> jnp.ndarray:
    """Exact coarse GEMM over survivor POSITIONS with the full static
    (K, N) weight matrix: (B, m_cap, N).  No weight gather at all, and no
    full patch-matrix materialization either: the (B, P, K) patch tensor is
    ~1.7 GB at reference scale, while the (Hc+Kc, Wc+Kc, C*T*T)
    linearized-cell tensor it is built from is ~300x smaller — so gather
    each survivor's Kc*Kc cell vectors straight from the small tensor
    (column order matches _gemm_patches' block concat:
    (qy*Kc + qx)*C*T*T + channel-subcell)."""
    B = Rb.shape[0]
    m_cap = p_idx.shape[1]
    P_sub = assemble_survivor_patches(Rb, p_idx, T, Kc)
    raw = jax.lax.dot_general(
        P_sub.reshape(B * m_cap, -1), W_gemm,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return raw.reshape(B, m_cap, -1)


@partial(jax.jit, static_argnames=("top_k", "Wc"))
def select_candidates_flat_pos(
    raw_sub: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    p_idx: jnp.ndarray,
    p_keep: jnp.ndarray,
    threshold: float,
    top_k: int,
    Wc: int,
) -> CoarseMatches:
    """Candidate selection over the (m_cap, N) survivor-position scores of
    ONE frame; positions map back through p_idx.  The valid (>= threshold)
    candidate set matches the exhaustive path's exactly (no overflow)."""
    m_cap, N = raw_sub.shape
    scale = similarity_scale(total_features)
    vpos_sub = vpos_flat[p_idx] & p_keep[:, None]
    sim = jnp.where(vpos_sub, raw_sub.astype(jnp.float32) * scale[None, :], -1.0)
    flat = sim.reshape(-1)
    k = min(top_k, flat.shape[0])
    vals, fidx = jax.lax.top_k(flat, k)
    t_sub = fidx % N
    pos = p_idx[fidx // N]
    return CoarseMatches(
        t_sub.astype(jnp.int32),
        (pos // Wc).astype(jnp.int32),
        (pos % Wc).astype(jnp.int32),
        vals,
        vals >= threshold,
    )


@partial(jax.jit, static_argnames=("C", "T", "Kc", "g"))
def build_cell_weights_fine(
    feats: LevelFeatures, C: int, T: int, Kc: int, g: int
) -> jnp.ndarray:
    """(N, (Kc*T/g)^2 * C) int8 feature counts per (g x g subcell,
    orientation) bin — the second-stage (fine) upper-bound GEMM's weights.
    Column order is subcell-row-major: (sy * KS + sx) * C + ori with
    sy = offset_y // g over the Kc*T-pixel survivor window."""
    if T % g != 0:
        raise ValueError(f"g={g} must divide T={T}")
    KS = Kc * T // g
    N, Fmax = feats.oris.shape
    sy = jnp.clip(feats.offsets[..., 0] // g, 0, KS - 1)
    sx = jnp.clip(feats.offsets[..., 1] // g, 0, KS - 1)
    col = (sy * KS + sx) * C + feats.oris
    Wf = jnp.zeros((N, KS * KS * C), jnp.int8)
    return Wf.at[jnp.arange(N)[:, None], col].add(
        jnp.where(feats.live, jnp.int8(1), jnp.int8(0))
    )


@partial(jax.jit, static_argnames=("T", "Kc", "g"))
def fine_ub_at_survivors(
    Rb: jnp.ndarray,
    p_idx: jnp.ndarray,
    W_fine: jnp.ndarray,
    T: int,
    Kc: int,
    g: int,
) -> jnp.ndarray:
    """Second-stage upper bound at survivor positions: (B, m, N) int32.

    The g x g max-pooled response plane dominates the exact per-pixel
    response (each feature's pixel lies inside its subcell block), so
    ub_fine >= exact raw score — a TIGHTER bound than the T x T cell-max
    (prune_positions_batched) at 1/64th the exhaustive GEMM's arithmetic:
    (B*m, (Kc*T/g)^2*C) x (..., N).  Survivor patch assembly reuses
    gather_cell_patches_onehot on the pooled plane (same separable
    one-hot gather, C riding the minor axis, window KS over the
    subcell grid) — the pooled plane is ~T^2/g^2 smaller than the full
    response tensor, so its intermediates stay tens of MB."""
    B, C, H, W = Rb.shape
    Hc, Wc_ = H // T, W // T
    S = T // g
    KS = Kc * S
    Hs, Ws = Hc * S, Wc_ * S
    Rm = Rb[:, :, : Hc * T, : Wc_ * T].reshape(B, C, Hs, g, Ws, g).max(axis=(3, 5))
    Pp = jnp.pad(
        Rm.transpose(0, 2, 3, 1), [(0, 0), (0, KS), (0, KS), (0, 0)]
    ).astype(jnp.int8)  # (B, Hs+KS, Ws+KS, C)
    m = p_idx.shape[1]
    # Survivor cells on the subcell grid: (py*S, px*S) of an (Hs, Ws) map.
    p_sub = (p_idx // Wc_) * S * Ws + (p_idx % Wc_) * S
    Pub = gather_cell_patches_onehot(Pp, p_sub.astype(jnp.int32), KS, Ws)
    ub = jax.lax.dot_general(
        Pub.reshape(B * m, KS * KS * C), W_fine,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return ub.reshape(B, m, -1)


class FinePlan(NamedTuple):
    """Second-stage (g x g subcell bound) survivor-position compaction.

    p_idx:       (B, m2_cap) int32 — fine-surviving flat positions
                 (compacted from the coarse PrunePlan's p_idx)
    p_keep:      (B, m2_cap) bool  — slot holds a live position
    m_survivors: (B,)        int32 — true fine-survivor count per frame
    overflow:    ()          bool  — any frame exceeded m2_cap: callers
                                     must fall back to the coarse
                                     survivor set to stay exact
    """

    p_idx: jnp.ndarray
    p_keep: jnp.ndarray
    m_survivors: jnp.ndarray
    overflow: jnp.ndarray


@partial(jax.jit, static_argnames=("m2_cap",))
def fine_plan_from_ub(
    ub_fine: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    p_idx: jnp.ndarray,
    p_keep: jnp.ndarray,
    threshold: float,
    m2_cap: int,
) -> FinePlan:
    """Coarse survivors -> fine survivors: a position stays only if SOME
    template's fine bound still reaches threshold there.  Measured on real
    bin-picking scenes the g=4 bound kills ~40% of coarse survivors (mean
    46 -> 28 of m_cap 96), and the exact GEMM + patch assembly both scale
    linearly in the position count.  Exactness: ub_fine dominates the
    exact raw score, so every (position, template) pair whose exact
    similarity >= threshold keeps its position (threshold slack identical
    to prune_positions_batched's int rule)."""
    B, m, N = ub_fine.shape
    t_f = int_score_threshold(threshold, total_features).astype(jnp.int32)
    margin = jnp.where(
        vpos_flat[p_idx], ub_fine - t_f[None, None, :], -(2**30)
    )
    p_score = jnp.max(margin, axis=2)  # (B, m)
    keep2 = (p_score >= 0) & p_keep
    m_surv = jnp.sum(keep2.astype(jnp.int32), axis=1)
    km = min(m2_cap, m)
    pv, j2 = jax.lax.top_k(jnp.where(keep2, p_score, -(2**30)), km)
    p_idx2 = jnp.take_along_axis(p_idx, j2, axis=1)
    return FinePlan(
        p_idx2.astype(jnp.int32), pv > -(2**30), m_surv,
        jnp.any(m_surv > km),
    )


@partial(jax.jit, static_argnames=(
    "T", "Kc", "g", "m_cap", "m2_cap", "top_k", "Wc"
))
def match_coarse_pruned_fine_with_fallback(
    Rb: jnp.ndarray,
    W_gemm: jnp.ndarray,
    W_cell: jnp.ndarray,
    W_fine: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    T: int,
    Kc: int,
    g: int,
    m_cap: int,
    m2_cap: int,
    top_k: int,
    Wc: int,
) -> tuple[CoarseMatches, PrunePlan, FinePlan]:
    """Two-stage exact hierarchical position pruning with in-graph
    fallbacks.

    Stage 1 (prune_positions_batched): T x T cell-max bound over every
    coarse position -> m_cap survivor positions per frame.
    Stage 2 (fine_ub_at_survivors + fine_plan_from_ub): g x g subcell
    bound at survivors -> the ~60% of coarse survivors that can still
    reach threshold, compacted to m2_cap.
    Exact pass: survivor patches x the SAME static (K, N) weight matrix
    as the exhaustive engine — no weight gather (a batch-union template
    axis was tried first: its (u_cap, K) row gather of the weight matrix
    cost more than the arithmetic it saved).

    Fallbacks keep the candidate set UNCONDITIONALLY exact, matching
    cv::linemod's score-every-position semantics (rgbdDetector.cpp:31-34):
    fine overflow -> exact GEMM over all m_cap coarse survivors; coarse
    overflow -> exhaustive GEMM over all positions.  Both ride lax.cond so
    only the taken branch executes; predicates stay on device.
    """
    pp = prune_positions_batched(
        Rb, W_cell, total_features, vpos_flat, threshold, T, Kc, m_cap
    )
    km2 = min(m2_cap, pp.p_idx.shape[1])

    def _sel(raw, pi, pk):
        return jax.vmap(
            lambda r, i, k: select_candidates_flat_pos(
                r, total_features, vpos_flat, i, k, threshold, top_k, Wc
            )
        )(raw, pi, pk)

    def _coarse(_):
        raw = coarse_scores_gemm_flat_batched_pos(
            Rb, W_gemm, pp.p_idx, T, Kc
        )
        return _sel(raw, pp.p_idx, pp.p_keep)

    def _pruned(_):
        # The fine bound lives INSIDE the non-overflow branch: a
        # coarse-overflow batch goes straight to the exhaustive pass
        # without paying the fine-stage GEMM it would discard.
        ubf = fine_ub_at_survivors(Rb, pp.p_idx, W_fine, T, Kc, g)
        fp = fine_plan_from_ub(
            ubf, total_features, vpos_flat, pp.p_idx, pp.p_keep, threshold,
            m2_cap,
        )

        def _fine(_):
            raw = coarse_scores_gemm_flat_batched_pos(
                Rb, W_gemm, fp.p_idx, T, Kc
            )
            return _sel(raw, fp.p_idx, fp.p_keep)

        return jax.lax.cond(fp.overflow, _coarse, _fine, None), fp

    def _exhaustive(_):
        raw = coarse_scores_gemm_flat_batched(Rb, W_gemm, T, Kc)
        cands = jax.vmap(
            lambda r: select_candidates_flat(
                r, total_features, vpos_flat, threshold, top_k, Wc
            )
        )(raw)
        # Placeholder plan (the fine stage never ran): shapes match the
        # live branch; p_keep all-False marks it as holding nothing.
        B = Rb.shape[0]
        dummy = FinePlan(
            pp.p_idx[:, :km2],
            jnp.zeros((B, km2), bool),
            jnp.zeros((B,), jnp.int32),
            jnp.asarray(False),
        )
        return cands, dummy

    cands, fp = jax.lax.cond(pp.overflow, _exhaustive, _pruned, None)
    return cands, pp, fp


@partial(jax.jit, static_argnames=(
    "T", "Kc", "m_cap", "top_k", "Wc"
))
def match_coarse_pruned_with_fallback(
    Rb: jnp.ndarray,
    W_gemm: jnp.ndarray,
    W_cell: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    T: int,
    Kc: int,
    m_cap: int,
    top_k: int,
    Wc: int,
) -> tuple[CoarseMatches, PrunePlan]:
    """Position-pruned coarse pass with an IN-GRAPH exhaustive fallback:
    if any frame's survivor-position count exceeds m_cap (PrunePlan.
    overflow), a lax.cond re-runs the whole batch through the exhaustive
    GEMM + select instead of the capped survivor GEMM, so the candidate
    set is UNCONDITIONALLY exact — matching cv::linemod's semantics, which
    scores every position (rgbdDetector.cpp:31-34) — with no host sync on
    the hot path (the cond predicate stays on device; the exhaustive
    branch only executes, and only pays, on overflow).

    Returns (batched CoarseMatches over (B, top_k), PrunePlan)."""
    B = Rb.shape[0]
    pp = prune_positions_batched(
        Rb, W_cell, total_features, vpos_flat, threshold, T, Kc, m_cap
    )

    def _pruned(_):
        raw = coarse_scores_gemm_flat_batched_pos(
            Rb, W_gemm, pp.p_idx, T, Kc,
        )
        return jax.vmap(
            lambda r, pi, pk: select_candidates_flat_pos(
                r, total_features, vpos_flat, pi, pk, threshold, top_k, Wc
            )
        )(raw, pp.p_idx, pp.p_keep)

    def _exhaustive(_):
        raw = coarse_scores_gemm_flat_batched(Rb, W_gemm, T, Kc)
        return jax.vmap(
            lambda r: select_candidates_flat(
                r, total_features, vpos_flat, threshold, top_k, Wc
            )
        )(raw)

    cands = jax.lax.cond(pp.overflow, _exhaustive, _pruned, None)
    return cands, pp


# ---------------------------------------------------------------------------
# Batch-shared survivor POOL: per-frame fallback granularity.
#
# The per-frame-cap planner above sizes every stage by B * m_cap and trips
# its in-graph fallback when ANY frame exceeds the cap (jnp.any over the
# batch) — one busy frame makes the whole batch pay the slow branch, which
# forces conservative caps.  Here the
# survivor axis is ONE flat pool shared by the batch: each candidate carries
# its frame id, a busy frame simply takes more pool slots, and the only
# overflow condition is the batch-TOTAL survivor count — whose variance is
# far smaller than the per-frame max, so the pool runs at ~1.3x the mean
# where per-frame caps needed ~2x.  The pool is built FRAME-MAJOR (exact
# order-preserving compaction, no sort), so per-frame selection reads a
# contiguous slot range and reuses the per-frame select kernel unchanged.
# Exactness contract is identical to the capped path: every stage bound
# dominates the exact score, and any overflow (or select-capacity miss)
# routes the batch through the exhaustive GEMM in-graph
# (cv::linemod scores every position — rgbdDetector.cpp:31-34).
# ---------------------------------------------------------------------------


class PoolPlan(NamedTuple):
    """Frame-major survivor pool over a frame batch.

    frame: (M,) int32 — owning frame per pool slot (nondecreasing)
    pos:   (M,) int32 — flat coarse cell within that frame
    keep:  (M,) bool  — slot holds a live survivor
    starts:(B,) int32 — first pool slot of each frame (exclusive cumsum of
                        m_survivors; valid only while total <= M)
    m_survivors: (B,) int32 — TRUE per-frame eligible counts (uncapped)
    total: ()  int32 — true batch-total eligible count
    overflow: () bool — total > M: the pool is truncated and callers must
                        take the exhaustive fallback to stay exact
    """

    frame: jnp.ndarray
    pos: jnp.ndarray
    keep: jnp.ndarray
    starts: jnp.ndarray
    m_survivors: jnp.ndarray
    total: jnp.ndarray
    overflow: jnp.ndarray


@partial(jax.jit, static_argnames=("cap",))
def _compact_eligible_flat(elig: jnp.ndarray, cap: int):
    """Exact, order-preserving compaction of the set bits of `elig` (L,)
    into `cap` slots: (idx (cap,) int32 ascending, keep (cap,), total ()).

    Sort-free: exclusive-cumsum ranks + ONE one-hot f32 matmul recover the i-th set
    bit's index (L < 2^24 keeps f32 index arithmetic exact).  When
    total > cap the first `cap` eligible entries fill the pool and the
    caller must treat the plan as overflowed; dead slots hold idx 0."""
    L = elig.shape[0]
    e32 = elig.astype(jnp.int32)
    r = jnp.cumsum(e32) - e32  # exclusive rank of each entry
    total = r[-1] + e32[-1]
    oh = jnp.where(
        elig[:, None] & (r[:, None] == jnp.arange(cap, dtype=jnp.int32)[None, :]),
        jnp.float32(1.0), jnp.float32(0.0),
    )  # (L, cap)
    idx = jax.lax.dot_general(
        oh, jnp.arange(L, dtype=jnp.float32),
        dimension_numbers=(((0,), (0,)), ((), ())),
    )  # (cap,)
    keep = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(total, cap)
    return idx.astype(jnp.int32), keep, total


@partial(jax.jit, static_argnames=("cap",))
def pool_plan_from_margins(margins: jnp.ndarray, cap: int) -> PoolPlan:
    """(B, P) int32 position margins (position_margins_batched) -> the
    frame-major PoolPlan of every eligible (margin >= 0) position."""
    B, P = margins.shape
    elig = (margins >= 0).reshape(-1)
    idx, keep, total = _compact_eligible_flat(elig, cap)
    m_surv = jnp.sum((margins >= 0).astype(jnp.int32), axis=1)
    starts = jnp.cumsum(m_surv) - m_surv
    return PoolPlan(
        frame=idx // P, pos=idx % P, keep=keep, starts=starts,
        m_survivors=m_surv, total=total, overflow=total > cap,
    )


@partial(jax.jit, static_argnames=("C", "T", "Kc", "group"))
def build_group_bound(
    feats: LevelFeatures, C: int, T: int, Kc: int, group: int,
    W_cell: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Group-max cell-bound weights: (Ng, C*Kc*Kc) int8 with
    W_group[g, bin] = max over the group's templates of W_cell[n, bin],
    plus the members' feature counts (Ng, group) int32 (0 = dead slot).

    For every template n in group g and any position p,
      ub(p, n) = P_ub[p] . W_cell[n] <= P_ub[p] . W_group[g]
    (P_ub >= 0), so a GROUP margin with the group's loosest integer
    threshold dominates every member's margin — a pre-bound with
    `group`x fewer GEMM columns whose survivors are re-tested by the
    per-template bound at pooled positions only (pool_plan_grouped).
    Banks order templates along the view-sphere walk, so neighbours are
    similar views and the group max stays tight.

    Pass the caller's existing `W_cell` (every production caller already
    holds it) to skip rebuilding the (N, bins) scatter."""
    Wc_ = build_cell_weights(feats, C, T, Kc) if W_cell is None else W_cell
    N = Wc_.shape[0]
    Ng = -(-N // group)
    pad = Ng * group - N
    Wp = jnp.pad(Wc_, [(0, pad), (0, 0)])
    W_group = Wp.reshape(Ng, group, -1).max(axis=1)
    counts = jnp.pad(feats.count, [(0, pad)]).reshape(Ng, group)
    return W_group, counts


@partial(jax.jit, static_argnames=("T", "Kc", "pool0", "pool1", "group"))
def pool_plan_grouped(
    Rb: jnp.ndarray,
    W_cell: jnp.ndarray,
    W_group: jnp.ndarray,
    group_counts: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    T: int,
    Kc: int,
    pool0: int,
    pool1: int,
    group: int,
) -> PoolPlan:
    """Two-tier pooled position planning: the group-max pre-bound over
    EVERY position (group x fewer GEMM columns and no (B, P, N) epilogue
    tensor), a loose frame-major pool of its survivors (pool0), then the
    per-template cell bound evaluated ONLY at those pooled positions to
    recover exactly the eligible set position_margins_batched would give
    (pool1).  Every tier is a superset of the one below, so the plan's
    survivor set equals the ungrouped plan's whenever no pool overflows
    (equality-tested in tests/test_pool.py); overflow at either tier sets
    PoolPlan.overflow and the caller falls back."""
    B, C, H, W = Rb.shape
    Hc, Wc_ = H // T, W // T
    P = Hc * Wc_
    N = W_cell.shape[0]
    Ng = W_group.shape[0]

    # Tier 0: group bound at every position.
    P_ub = jax.vmap(lambda R: _ub_patches(R, T, Kc))(Rb).reshape(B * P, -1)
    ubg = jax.lax.dot_general(
        P_ub, W_group,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (B*P, Ng)
    t_int = int_score_threshold(threshold, total_features).astype(jnp.int32)
    t_pad = jnp.pad(t_int, [(0, Ng * group - N)]).reshape(Ng, group)
    t_g = jnp.min(
        jnp.where(group_counts > 0, t_pad, jnp.int32(2**30)), axis=1
    )  # loosest live member (dead groups -> +inf, never eligible)
    vpad = jnp.pad(vpos_flat, [(0, 0), (0, Ng * group - N)])
    vpos_g = jnp.any(vpad.reshape(P, Ng, group), axis=2)  # (P, Ng)
    margin_g = jnp.where(
        jnp.tile(vpos_g, (B, 1)), ubg - t_g[None, :], -(2**30)
    )
    p0_margins = jnp.max(margin_g, axis=1).reshape(B, P)
    pp0 = pool_plan_from_margins(p0_margins, pool0)

    # Tier 1: per-template cell bound at the pooled positions only.
    Rm = Rb[:, :, : Hc * T, : Wc_ * T].reshape(B, C, Hc, T, Wc_, T).max(
        axis=(3, 5))
    Mp = jnp.pad(
        Rm.transpose(0, 2, 3, 1), [(0, 0), (0, Kc), (0, Kc), (0, 0)]
    ).astype(jnp.int8)  # (B, Hc+Kc, Wc+Kc, C)
    Hy = Hc + Kc
    L3 = Mp.reshape(B * Hy, Wc_ + Kc, C)
    Pub = gather_windows_pooled(
        L3, pp0.frame * Hy + pp0.pos // Wc_, pp0.pos % Wc_, Kc
    )  # (M0, Kc*Kc*C) — same column order as build_cell_weights
    ub = jax.lax.dot_general(
        Pub, W_cell,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (M0, N)
    margin = jnp.where(
        vpos_flat[pp0.pos] & pp0.keep[:, None], ub - t_int[None, :], -(2**30)
    )
    elig = jnp.max(margin, axis=1) >= 0  # (M0,)
    idx, keep, total = _compact_eligible_flat(elig, pool1)
    frame = pp0.frame[idx]
    pos = pp0.pos[idx]
    ohf = (pp0.frame[:, None] == jnp.arange(B, dtype=jnp.int32)[None, :]) \
        & elig[:, None]
    m_surv = jnp.sum(ohf.astype(jnp.int32), axis=0)
    starts = jnp.cumsum(m_surv) - m_surv
    return PoolPlan(
        frame=frame, pos=pos, keep=keep, starts=starts, m_survivors=m_surv,
        total=total, overflow=pp0.overflow | (total > pool1),
    )


@partial(jax.jit, static_argnames=("K",))
def gather_windows_pooled(
    L3: jnp.ndarray, row0: jnp.ndarray, col0: jnp.ndarray, K: int,
) -> jnp.ndarray:
    """Window gather over a flat candidate POOL, by XLA's gather:
    out[m, qy, qx, :] = L3[row0[m]+qy, col0[m]+qx, :] (zero out of range).

    L3: (G, Wx, Ct) int8 — frame-STACKED row-linearized planes (G = B*Hy);
    a candidate's K consecutive rows stay inside its frame's Hy block
    because each per-frame plane carries K rows of bottom padding, which
    is what lets one flat pool address the whole batch.  Returns
    (M, K*K*Ct) int8 in the (qy*K + qx)*Ct + lane order of _gemm_patches
    / build_gemm_weights."""
    Ct = L3.shape[2]
    M_ = row0.shape[0]
    q = jnp.arange(K, dtype=jnp.int32)
    rows = (row0[:, None] + q[None, :])[:, :, None]  # (M, K, 1)
    cols = (col0[:, None] + q[None, :])[:, None, :]  # (M, 1, K)
    win = L3.at[rows, cols].get(mode="fill", fill_value=0)  # (M, K, K, Ct)
    return win.reshape(M_, K * K * Ct)


@partial(jax.jit, static_argnames=("T", "Kc", "g"))
def fine_ub_at_pool(
    Rb: jnp.ndarray,
    frame: jnp.ndarray,
    pos: jnp.ndarray,
    W_fine: jnp.ndarray,
    T: int,
    Kc: int,
    g: int,
) -> jnp.ndarray:
    """Second-stage (g x g subcell) upper bound at POOL candidates:
    (M, N) int32 — the pooled twin of fine_ub_at_survivors (same bound,
    same weights; the patch gather rides gather_windows_pooled over the
    frame-stacked pooled plane)."""
    B, C, H, W = Rb.shape
    Hc, Wc_ = H // T, W // T
    S = T // g
    KS = Kc * S
    Hs, Ws = Hc * S, Wc_ * S
    Rm = Rb[:, :, : Hc * T, : Wc_ * T].reshape(B, C, Hs, g, Ws, g).max(axis=(3, 5))
    Pp = jnp.pad(
        Rm.transpose(0, 2, 3, 1), [(0, 0), (0, KS), (0, KS), (0, 0)]
    ).astype(jnp.int8)  # (B, Hs+KS, Ws+KS, C)
    Hy = Hs + KS
    L3 = Pp.reshape(B * Hy, Ws + KS, C)
    row0 = frame * Hy + (pos // Wc_) * S
    col0 = (pos % Wc_) * S
    M_ = frame.shape[0]
    Pub = gather_windows_pooled(L3, row0, col0, KS).reshape(M_, KS * KS * C)
    return jax.lax.dot_general(
        Pub, W_fine,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (M, N)


@partial(jax.jit, static_argnames=("T", "Kc"))
def pooled_patches(
    Rb: jnp.ndarray,
    frame: jnp.ndarray,
    pos: jnp.ndarray,
    T: int,
    Kc: int,
) -> jnp.ndarray:
    """(M, K) int8 exact-GEMM patch rows of the pool candidates (frame,
    pos): the survivor-patch assembly of coarse_scores_gemm_pooled."""
    B, C, H, W = Rb.shape
    Hc, Wc_ = H // T, W // T
    with jax.named_scope("patches"):
        L = jax.vmap(lambda R: linearize_responses_lanes(R, T, Kc))(Rb)
        Hy = Hc + Kc
        CTT = C * T * T
        L3 = L.reshape(B * Hy, Wc_ + Kc, CTT).astype(jnp.int8)
        return gather_windows_pooled(L3, frame * Hy + pos // Wc_, pos % Wc_, Kc)


@partial(jax.jit, static_argnames=("T", "Kc"))
def coarse_scores_gemm_pooled(
    Rb: jnp.ndarray,
    W_gemm: jnp.ndarray,
    frame: jnp.ndarray,
    pos: jnp.ndarray,
    T: int,
    Kc: int,
) -> jnp.ndarray:
    """Exact coarse GEMM over POOL candidates: (M, N) int32 with the same
    static (K, N) weight matrix as the exhaustive engine (the pooled twin
    of coarse_scores_gemm_flat_batched_pos; scores are bit-identical rows
    of the exhaustive GEMM)."""
    P_sub = pooled_patches(Rb, frame, pos, T, Kc)
    with jax.named_scope("survivor_dot"):
        return jax.lax.dot_general(
            P_sub, W_gemm, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (M, N)


@partial(jax.jit, static_argnames=("top_k", "Wc", "r_cap"))
def select_candidates_pooled(
    raw: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    frame: jnp.ndarray,
    pos: jnp.ndarray,
    keep: jnp.ndarray,
    starts: jnp.ndarray,
    m_survivors: jnp.ndarray,
    threshold: float,
    top_k: int,
    Wc: int,
    r_cap: int,
):
    """Per-frame candidate selection from pooled scores (M, N): the
    frame-major pool makes each frame's rows a contiguous slot range, so
    frame b selects over a (r_cap, N) dynamic slice at starts[b] masked to
    its own rows — the SAME select_candidates_flat_pos kernel (and top-k
    semantics) as the per-frame-cap path.  r_cap only sizes this
    cheap select pass (one masked f32 convert over B*r_cap*N), not any
    GEMM; a frame with more than r_cap pool rows sets sel_overflow and the
    caller falls back to stay exact.

    Returns (CoarseMatches (B, top_k), n_valid (B,), sel_overflow ())."""
    M_, N = raw.shape
    B = starts.shape[0]
    rc = min(r_cap, M_)
    sel_overflow = jnp.any(m_survivors > rc)

    def one(b):
        s = jnp.clip(starts[b], 0, M_ - rc)
        rows = jax.lax.dynamic_slice(raw, (s, jnp.int32(0)), (rc, N))
        pos_b = jax.lax.dynamic_slice(pos, (s,), (rc,))
        fr_b = jax.lax.dynamic_slice(frame, (s,), (rc,))
        kp_b = jax.lax.dynamic_slice(keep, (s,), (rc,)) & (fr_b == b)
        return select_candidates_flat_pos(
            rows, total_features, vpos_flat, pos_b, kp_b, threshold, top_k, Wc
        )

    with jax.named_scope("select"):
        cands = jax.vmap(one)(jnp.arange(B, dtype=jnp.int32))
        n_valid = jnp.sum(cands.valid.astype(jnp.int32), axis=1)
    return cands, n_valid, sel_overflow


class PooledStats(NamedTuple):
    """Capacity telemetry of one pooled match step (all device-side).

    coarse_total/fine_total: () int32 — TRUE batch-total survivors
    coarse_m/fine_m: (B,) int32 — TRUE per-frame survivor counts
    coarse_overflow/fine_overflow/sel_overflow: () bool — per-stage pool
        or select-cap misses (each alone forces the in-graph fallback)
    fallback: () bool — the batch took the exhaustive branch
    """

    coarse_total: jnp.ndarray
    coarse_m: jnp.ndarray
    coarse_overflow: jnp.ndarray
    fine_total: jnp.ndarray
    fine_m: jnp.ndarray
    fine_overflow: jnp.ndarray
    sel_overflow: jnp.ndarray
    fallback: jnp.ndarray


@partial(jax.jit, static_argnames=("T", "Kc", "g", "cap"))
def fine_pool(
    Rb: jnp.ndarray,
    pp: PoolPlan,
    W_fine: jnp.ndarray,
    t_int: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    T: int,
    Kc: int,
    g: int,
    cap: int,
):
    """Second pooled stage: the g x g subcell bound at every coarse pool
    slot, then the frame-major compaction of the slots some template can
    still reach threshold at.  Returns (frame, pos, keep, starts, m_survivors
    (B,), total) of the fine pool; total > cap means it overflowed."""
    B = Rb.shape[0]
    with jax.named_scope("fine"):
        ubf = fine_ub_at_pool(Rb, pp.frame, pp.pos, W_fine, T, Kc, g)
        fmargin = jnp.where(
            vpos_flat[pp.pos] & pp.keep[:, None], ubf - t_int[None, :],
            -(2**30),
        )
        felig = jnp.max(fmargin, axis=1) >= 0  # (M1,)
        ohf = (pp.frame[:, None] == jnp.arange(B, dtype=jnp.int32)[None, :]) \
            & felig[:, None]
        fine_m = jnp.sum(ohf.astype(jnp.int32), axis=0)  # (B,)
        idx2, keep2, total2 = _compact_eligible_flat(felig, cap)
        starts2 = jnp.cumsum(fine_m) - fine_m
        return pp.frame[idx2], pp.pos[idx2], keep2, starts2, fine_m, total2


@partial(jax.jit, static_argnames=(
    "T", "Kc", "g", "pool1", "pool2", "top_k", "Wc", "r_cap", "pool0",
    "group"
))
def match_pooled_fine_with_fallback(
    Rb: jnp.ndarray,
    W_gemm: jnp.ndarray,
    W_cell: jnp.ndarray,
    W_fine: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    T: int,
    Kc: int,
    g: int,
    pool1: int,
    pool2: int,
    top_k: int,
    Wc: int,
    r_cap: int = 128,
    W_group: jnp.ndarray | None = None,
    group_counts: jnp.ndarray | None = None,
    pool0: int | None = None,
    group: int | None = None,
) -> tuple[CoarseMatches, jnp.ndarray, PooledStats]:
    """Two-stage exact pruning over a BATCH-SHARED survivor pool (the
    per-frame-granular twin of match_coarse_pruned_fine_with_fallback).

    Stage 1: T x T cell-max bound -> frame-major pool of ALL eligible
    positions across the batch (pool1 slots).  Stage 2: g x g subcell
    bound at pool candidates -> compacted fine pool (pool2 slots; the
    compaction preserves frame-major order).  Exact pass: pooled survivor
    patches x the static (K, N) weight matrix, then per-frame select over
    contiguous pool ranges.  One busy frame consumes more slots instead of
    tripping a per-frame cap — the fallbacks fire only on BATCH-TOTAL pool
    overflow (or a select-range miss), and all of them land on the
    exhaustive GEMM in one in-graph lax.cond, so the candidate set is
    UNCONDITIONALLY exact (cv::linemod semantics, rgbdDetector.cpp:31-34).

    Returns (CoarseMatches (B, top_k), n_valid (B,), PooledStats);
    n_valid feeds the refinement walk's live-prefix skip.

    With `W_group`/`group_counts`/`pool0`/`group` set (build_group_bound),
    the coarse plan routes through the two-tier pool_plan_grouped — the
    group-max pre-bound kills the full (B, P, N) bound GEMM + epilogue;
    the resulting plan holds the identical eligible set, so everything
    downstream (and the exactness argument) is unchanged."""
    if T % g != 0:
        # Same contract as build_cell_weights_fine / the multiclass twin:
        # fail here with the actionable message, not mid-trace in the
        # fine_ub reshape.
        raise ValueError(f"g={g} must divide T={T}")
    B = Rb.shape[0]
    with jax.named_scope("coarse"):
        if W_group is not None:
            pp = pool_plan_grouped(
                Rb, W_cell, W_group, group_counts, total_features, vpos_flat,
                threshold, T, Kc, pool0, pool1, group,
            )
        else:
            margins = position_margins_batched(
                Rb, W_cell, total_features, vpos_flat, threshold, T, Kc
            )
            pp = pool_plan_from_margins(margins, pool1)
    t_int = int_score_threshold(threshold, total_features).astype(jnp.int32)
    P2 = min(pool2, pool1)

    def _pooled(_):
        fp = fine_pool(Rb, pp, W_fine, t_int, vpos_flat, T, Kc, g, P2)
        frame2, pos2, keep2, starts2, fine_m, total2 = fp
        of2 = total2 > P2

        def _fine(_):
            raw = coarse_scores_gemm_pooled(Rb, W_gemm, frame2, pos2, T, Kc)
            return select_candidates_pooled(
                raw, total_features, vpos_flat, frame2, pos2, keep2,
                starts2, fine_m, threshold, top_k, Wc, r_cap,
            )

        def _coarse(_):
            raw = coarse_scores_gemm_pooled(Rb, W_gemm, pp.frame, pp.pos, T, Kc)
            return select_candidates_pooled(
                raw, total_features, vpos_flat, pp.frame, pp.pos, pp.keep,
                pp.starts, pp.m_survivors, threshold, top_k, Wc, r_cap,
            )

        cands, n_valid, sel_of = jax.lax.cond(of2, _coarse, _fine, None)
        return cands, n_valid, sel_of, total2, fine_m, of2

    def _skip(_):
        # Coarse pool overflowed: shape-matched dummies; the outer cond
        # routes to the exhaustive pass without paying the fine stage.
        # sel_overflow stays False — the select never ran, and reporting
        # it as overflowed would point capacity tuning at sel_row_cap
        # when the knob that actually overflowed is pool_coarse.
        z = jnp.zeros((B, top_k), jnp.int32)
        cands = CoarseMatches(z, z, z, jnp.full((B, top_k), -1.0, jnp.float32),
                              jnp.zeros((B, top_k), bool))
        return (cands, jnp.zeros((B,), jnp.int32), jnp.asarray(False),
                jnp.asarray(0, jnp.int32), jnp.zeros((B,), jnp.int32),
                jnp.asarray(False))

    cands, n_valid, sel_of, fine_total, fine_m, of2 = jax.lax.cond(
        pp.overflow, _skip, _pooled, None
    )
    fallback = pp.overflow | sel_of

    def _exhaustive(op):
        raw = coarse_scores_gemm_flat_batched(Rb, W_gemm, T, Kc)
        c = jax.vmap(
            lambda r: select_candidates_flat(
                r, total_features, vpos_flat, threshold, top_k, Wc
            )
        )(raw)
        nv = jnp.sum(c.valid.astype(jnp.int32), axis=1)
        return c, nv

    cands, n_valid = jax.lax.cond(
        fallback, _exhaustive, lambda op: op, (cands, n_valid)
    )
    stats = PooledStats(
        coarse_total=pp.total, coarse_m=pp.m_survivors,
        coarse_overflow=pp.overflow, fine_total=fine_total, fine_m=fine_m,
        fine_overflow=of2, sel_overflow=sel_of, fallback=fallback,
    )
    return cands, n_valid, stats


@partial(jax.jit, static_argnames=(
    "class_slices", "thresholds", "T", "Kc", "g", "pool1", "pool2",
    "top_k", "Wc", "r_cap"
))
def match_pooled_multiclass(
    Rb: jnp.ndarray,
    W_gemm: jnp.ndarray,
    W_cell: jnp.ndarray,
    W_fine: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    class_slices: tuple[tuple[int, int], ...],
    thresholds: tuple[float, ...],
    T: int,
    Kc: int,
    g: int,
    pool1: int,
    pool2: int,
    top_k: int,
    Wc: int,
    r_cap: int = 128,
):
    """Pooled twin of match_coarse_pruned_multiclass over a MERGED bank:
    ONE margin pass + ONE pooled fine re-test (both at min(thresholds), so
    the pool is a superset for every class — still exact), ONE pooled
    exact GEMM over the merged template axis, then per-class pooled
    selects (each masking the other classes' columns at its own
    threshold).  Fallbacks identical to the single-class pooled path.

    Returns ([CoarseMatches (B, top_k) per class], [n_valid (B,) per
    class], PooledStats)."""
    B = Rb.shape[0]
    n_cls = len(class_slices)
    thr_min = min(thresholds)
    if T % g != 0:
        raise ValueError(f"g={g} must divide T={T}")
    N = W_gemm.shape[1]
    margins = position_margins_batched(
        Rb, W_cell, total_features, vpos_flat, thr_min, T, Kc
    )
    pp = pool_plan_from_margins(margins, pool1)
    t_int = int_score_threshold(thr_min, total_features).astype(jnp.int32)
    P2 = min(pool2, pool1)
    cls_cols = []
    for (lo, hi) in class_slices:
        cls_cols.append(jnp.zeros((N,), bool).at[lo:hi].set(True))

    def _sel_all(raw, frame, pos, keep, starts, m_surv):
        cands, nvs, sel_of = [], [], jnp.asarray(False)
        for col, thr_c in zip(cls_cols, thresholds):
            c, nv, so = select_candidates_pooled(
                raw, total_features, vpos_flat & col[None, :], frame, pos,
                keep, starts, m_surv, thr_c, top_k, Wc, r_cap,
            )
            cands.append(c)
            nvs.append(nv)
            sel_of = sel_of | so
        return tuple(cands), tuple(nvs), sel_of

    def _pooled(_):
        fp = fine_pool(Rb, pp, W_fine, t_int, vpos_flat, T, Kc, g, P2)
        frame2, pos2, keep2, starts2, fine_m, total2 = fp
        of2 = total2 > P2

        def _fine(_):
            raw = coarse_scores_gemm_pooled(Rb, W_gemm, frame2, pos2, T, Kc)
            return _sel_all(raw, frame2, pos2, keep2, starts2, fine_m)

        def _coarse(_):
            raw = coarse_scores_gemm_pooled(Rb, W_gemm, pp.frame, pp.pos, T, Kc)
            return _sel_all(raw, pp.frame, pp.pos, pp.keep, pp.starts,
                            pp.m_survivors)

        cands, nvs, sel_of = jax.lax.cond(of2, _coarse, _fine, None)
        return cands, nvs, sel_of, total2, fine_m, of2

    def _skip(_):
        # sel_overflow stays False here too — see the single-class _skip.
        z = jnp.zeros((B, top_k), jnp.int32)
        c = CoarseMatches(z, z, z, jnp.full((B, top_k), -1.0, jnp.float32),
                          jnp.zeros((B, top_k), bool))
        return (tuple(c for _ in range(n_cls)),
                tuple(jnp.zeros((B,), jnp.int32) for _ in range(n_cls)),
                jnp.asarray(False), jnp.asarray(0, jnp.int32),
                jnp.zeros((B,), jnp.int32), jnp.asarray(False))

    cands, nvs, sel_of, fine_total, fine_m, of2 = jax.lax.cond(
        pp.overflow, _skip, _pooled, None
    )
    fallback = pp.overflow | sel_of

    def _exhaustive(op):
        raw = coarse_scores_gemm_flat_batched(Rb, W_gemm, T, Kc)
        cs, ns = [], []
        for col, thr_c in zip(cls_cols, thresholds):
            c = jax.vmap(
                lambda r: select_candidates_flat(
                    r, total_features, vpos_flat & col[None, :], thr_c,
                    top_k, Wc,
                )
            )(raw)
            cs.append(c)
            ns.append(jnp.sum(c.valid.astype(jnp.int32), axis=1))
        return tuple(cs), tuple(ns)

    cands, nvs = jax.lax.cond(
        fallback, _exhaustive, lambda op: op, (cands, nvs)
    )
    stats = PooledStats(
        coarse_total=pp.total, coarse_m=pp.m_survivors,
        coarse_overflow=pp.overflow, fine_total=fine_total, fine_m=fine_m,
        fine_overflow=of2, sel_overflow=sel_of, fallback=fallback,
    )
    return list(cands), list(nvs), stats


def merge_candidates_sorted(
    cands: Sequence[CoarseMatches],
) -> tuple[CoarseMatches, jnp.ndarray]:
    """Concatenate per-class (B, K) candidates and re-sort each frame so
    the valid candidates form ONE similarity-sorted prefix — the walk
    skip's precondition, which a raw concat violates (class A's
    sub-threshold filler lands before class B's valid candidates, and the
    prefix guard would walk every slot).  Returns (merged (B, sum K),
    n_valid (B,)); candidates map back to classes by template-id range."""
    cat = CoarseMatches(*(jnp.concatenate(a, axis=1) for a in zip(*cands)))
    key = jnp.where(cat.valid, cat.similarity, -jnp.inf)
    _, idx = jax.lax.top_k(key, key.shape[1])
    take = lambda a: jnp.take_along_axis(a, idx, axis=1)
    merged = CoarseMatches(
        take(cat.template_id), take(cat.cell_y), take(cat.cell_x),
        take(cat.similarity), take(cat.valid),
    )
    return merged, jnp.sum(cat.valid.astype(jnp.int32), axis=1)


def split_matches_by_class(
    m: Matches,
    class_slices: tuple[tuple[int, int], ...],
    top_k: int,
) -> list[Matches]:
    """Split walked merged-bank matches back into per-class (B, top_k)
    records: class membership is the template-id range, per-class slots
    are the frame's top_k by similarity among that class's valid matches,
    ids re-based to the class's own bank."""
    out = []
    for (lo, hi) in class_slices:
        mine = m.valid & (m.template_id >= lo) & (m.template_id < hi)
        key = jnp.where(mine, m.similarity, -jnp.inf)
        vals, idx = jax.lax.top_k(key, min(top_k, key.shape[1]))
        take = lambda a: jnp.take_along_axis(a, idx, axis=1)
        out.append(Matches(
            template_id=take(m.template_id) - lo,
            x=take(m.x), y=take(m.y), similarity=take(m.similarity),
            valid=take(mine),
        ))
    return out


def _default_cap(cap: int | None, parent_cap: int, name: str) -> int:
    """None -> half the parent cap; non-positive explicit values error
    (an explicit 0 must not silently become the default)."""
    if cap is None:
        return max(parent_cap // 2, 1)
    if cap <= 0:
        raise ValueError(f"{name} must be positive (got {cap}); pass None "
                         "for the default")
    return cap


def concat_level_features(feats_list: list[LevelFeatures]) -> tuple[LevelFeatures, tuple[int, ...]]:
    """Merge several classes' LevelFeatures into ONE template axis.

    cv::linemod's Detector::match scores every class in one call
    (linemod.cpp Detector::match over class_ids; the reference's two-object
    service alternates two single-class detectors and pays preprocess +
    patch assembly + the prune bound twice).  Merging the template axes
    lets one preprocess + one prune + one GEMM + one refinement dispatch
    serve all classes; per-class selection slices the shared score tensor.

    Returns (merged, bases): bases[i] = first template row of class i
    (class i owns rows [bases[i], bases[i+1])); subtract to re-base ids.
    """
    fmax = max(int(f.oris.shape[1]) for f in feats_list)

    def padf(a, F):
        return jnp.pad(a, [(0, 0), (0, fmax - F)] + [(0, 0)] * (a.ndim - 2))

    bases, off = [], 0
    for f in feats_list:
        bases.append(off)
        off += int(f.oris.shape[0])
    merged = LevelFeatures(
        offsets=jnp.concatenate([padf(f.offsets, f.offsets.shape[1]) for f in feats_list]),
        oris=jnp.concatenate([padf(f.oris, f.oris.shape[1]) for f in feats_list]),
        live=jnp.concatenate([padf(f.live, f.live.shape[1]) for f in feats_list]),
        count=jnp.concatenate([f.count for f in feats_list]),
        size=jnp.concatenate([f.size for f in feats_list]),
    )
    return merged, tuple(bases)


def tile_level_features(f: LevelFeatures, reps: int,
                        pad_to: int) -> LevelFeatures:
    """A bank's features repeated `reps` times along the template axis and
    padded with dead templates to `pad_to` rows — how benchmarks and
    chip_smoke.py grow the 2652-view bank to deployment scale.  Padded
    rows have no live features and a size no window fits, so they never
    score a valid position."""
    import numpy as np

    cat = lambda a: np.concatenate([np.asarray(a)] * reps, axis=0)
    offs, oris, live, cnt, size = (cat(a) for a in f)
    pad = pad_to - offs.shape[0]
    if pad < 0:
        raise ValueError(f"pad_to={pad_to} < {offs.shape[0]} tiled templates")
    z = lambda a: np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
    return LevelFeatures(
        jnp.asarray(z(offs)), jnp.asarray(z(oris)), jnp.asarray(z(live)),
        jnp.asarray(z(cnt)),
        jnp.asarray(np.pad(size, [(0, pad), (0, 0)], constant_values=10**6)),
    )


@partial(jax.jit, static_argnames=(
    "class_slices", "thresholds", "T", "Kc", "g", "m_cap", "m2_cap",
    "top_k", "Wc"
))
def match_coarse_pruned_multiclass(
    Rb: jnp.ndarray,
    W_gemm: jnp.ndarray,
    W_cell: jnp.ndarray,
    W_fine: jnp.ndarray | None,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    class_slices: tuple[tuple[int, int], ...],
    thresholds: tuple[float, ...],
    T: int,
    Kc: int,
    m_cap: int,
    top_k: int,
    Wc: int,
    g: int | None = 4,
    m2_cap: int | None = None,
) -> tuple[list[CoarseMatches], PrunePlan]:
    """Multi-class twin of match_coarse_pruned_fine_with_fallback over a
    MERGED bank (concat_level_features): ONE coarse prune + ONE fine
    re-test (both at min(thresholds), so the survivor set is a superset
    for every class — still exact), ONE survivor GEMM over the merged
    template axis, then a per-class selection that masks the other
    classes' score columns.  In-graph fallbacks on survivor overflow,
    exactly like the single-class path.  `W_fine=None` or `g=None` skips
    the fine stage (the round-3 behaviour).

    Returns ([CoarseMatches per class], PrunePlan)."""
    N = W_gemm.shape[1]
    thr_min = min(thresholds)
    if g is not None and T % g != 0:
        # Match build_cell_weights_fine and the sharded step: an
        # indivisible g is a caller error, not a silent coarse-only run.
        raise ValueError(f"g={g} must divide T={T} (pass g=None to disable "
                         "the fine stage)")
    pp = prune_positions_batched(
        Rb, W_cell, total_features, vpos_flat, thr_min, T, Kc, m_cap
    )
    cls_cols = []
    for (lo, hi) in class_slices:
        col = jnp.zeros((N,), bool).at[lo:hi].set(True)
        cls_cols.append(col)

    def _sel_pos(raw, pi, pk):
        out = []
        for col, thr_c in zip(cls_cols, thresholds):
            out.append(jax.vmap(
                lambda r, i, k: select_candidates_flat_pos(
                    r, total_features, vpos_flat & col[None, :], i, k,
                    thr_c, top_k, Wc
                )
            )(raw, pi, pk))
        return out

    def _coarse(_):
        raw = coarse_scores_gemm_flat_batched_pos(
            Rb, W_gemm, pp.p_idx, T, Kc,
        )
        return _sel_pos(raw, pp.p_idx, pp.p_keep)

    def _exhaustive(_):
        raw = coarse_scores_gemm_flat_batched(Rb, W_gemm, T, Kc)
        out = []
        for col, thr_c in zip(cls_cols, thresholds):
            out.append(jax.vmap(
                lambda r: select_candidates_flat(
                    r, total_features, vpos_flat & col[None, :], thr_c,
                    top_k, Wc
                )
            )(raw))
        return out

    if g is not None and W_fine is not None:
        def _pruned(_):
            # Fine stage only in the non-overflow branch (see the
            # single-class orchestrator).
            ubf = fine_ub_at_survivors(Rb, pp.p_idx, W_fine, T, Kc, g)
            fp = fine_plan_from_ub(
                ubf, total_features, vpos_flat, pp.p_idx, pp.p_keep,
                thr_min, _default_cap(m2_cap, m_cap, "m2_cap"),
            )

            def _fine(_):
                raw = coarse_scores_gemm_flat_batched_pos(
                    Rb, W_gemm, fp.p_idx, T, Kc,
                )
                return _sel_pos(raw, fp.p_idx, fp.p_keep)

            return jax.lax.cond(fp.overflow, _coarse, _fine, None)

        cands = jax.lax.cond(pp.overflow, _exhaustive, _pruned, None)
    else:
        cands = jax.lax.cond(pp.overflow, _exhaustive, _coarse, None)
    return cands, pp


@partial(jax.jit, static_argnames=("T", "Kc"))
def coarse_scores_gemm_flat_batched_sub(
    Rb: jnp.ndarray, W_rows: jnp.ndarray, idx: jnp.ndarray, T: int, Kc: int
) -> jnp.ndarray:
    """Exact coarse GEMM over survivor templates only: (B, Hc*Wc, n_cap).

    W_rows is the TEMPLATE-MAJOR one-hot weight matrix (N, C*T*T*Kc*Kc) —
    row gathers are contiguous reads, unlike column gathers of the (K, N)
    layout.  Scores for dead `idx` slots are garbage; callers mask
    them via PruneResult.keep (select_candidates_flat_sub does)."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    W_sub = W_rows[idx]  # (n_cap, K_dim)
    P = jax.vmap(lambda R: _gemm_patches(R, T, Kc))(Rb).reshape(B * Hc * Wc, -1)
    raw = jax.lax.dot_general(
        P,
        W_sub,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return raw.reshape(B, Hc * Wc, -1)


@partial(jax.jit, static_argnames=("top_k", "Wc"))
def select_candidates_flat_sub(
    raw_sub: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    idx: jnp.ndarray,
    keep: jnp.ndarray,
    threshold: float,
    top_k: int,
    Wc: int,
) -> CoarseMatches:
    """select_candidates_flat over survivor-compacted scores (Hc*Wc, n_cap):
    template ids map back through `idx`, dead slots mask to -1.  The valid
    (>= threshold) candidate set matches the exhaustive path's exactly."""
    P, n_cap = raw_sub.shape
    scale = similarity_scale(total_features[idx])
    vpos_sub = vpos_flat[:, idx] & keep[None, :]
    sim = jnp.where(vpos_sub, raw_sub.astype(jnp.float32) * scale[None, :], -1.0)
    flat = sim.reshape(-1)
    k = min(top_k, flat.shape[0])
    vals, fidx = jax.lax.top_k(flat, k)
    t_sub = fidx % n_cap
    pos = fidx // n_cap
    return CoarseMatches(
        idx[t_sub].astype(jnp.int32),
        (pos // Wc).astype(jnp.int32),
        (pos % Wc).astype(jnp.int32),
        vals,
        vals >= threshold,
    )


@partial(jax.jit, static_argnames=("T", "Kc"))
def coarse_scores_gemm(R: jnp.ndarray, W_gemm: jnp.ndarray, T: int, Kc: int) -> jnp.ndarray:
    """Raw scores (N, Hc, Wc) int32 (template-major view of
    coarse_scores_gemm_flat — prefer the flat form in hot paths)."""
    C, H, W = R.shape
    Hc, Wc = H // T, W // T
    raw = coarse_scores_gemm_flat(R, W_gemm, T, Kc)
    return raw.T.reshape(-1, Hc, Wc)


def position_validity_flat(size: jnp.ndarray, T: int, Hc: int, Wc: int) -> jnp.ndarray:
    """(Hc*Wc, N) bool — position-major twin of position_validity."""
    return position_validity(size, T, Hc, Wc).reshape(size.shape[0], -1).T


@partial(jax.jit, static_argnames=("top_k", "Wc"))
def select_candidates_flat(
    raw_flat: jnp.ndarray,
    total_features: jnp.ndarray,
    vpos_flat: jnp.ndarray,
    threshold: float,
    top_k: int,
    Wc: int,
) -> CoarseMatches:
    """Candidate selection over POSITION-MAJOR scores (Hc*Wc, N): one fused
    convert+mask pass, then lax.top_k, whose ties go to the lower index on
    every backend (so equal-scoring templates, e.g. a tiled bank's copies,
    resolve the same on CPU and GPU).  Same result set as select_candidates
    on the (N, Hc, Wc) layout."""
    P, N = raw_flat.shape
    scale = similarity_scale(total_features)
    sim = jnp.where(vpos_flat, raw_flat.astype(jnp.float32) * scale[None, :], -1.0)
    flat = sim.reshape(-1)
    k = min(top_k, flat.shape[0])
    vals, idx = jax.lax.top_k(flat, k)
    t = idx % N
    pos = idx // N
    return CoarseMatches(
        t.astype(jnp.int32),
        (pos // Wc).astype(jnp.int32),
        (pos % Wc).astype(jnp.int32),
        vals,
        vals >= threshold,
    )


def _compact_live_slots(offs, oris, live):
    """Stable live-first permutation of feature slots (per template or per
    candidate): returns (offsets, oris, live) reordered so live slots
    occupy [0, nf).

    The Triton walk (ops.walk_triton) walks features f < nf, which
    requires exactly this invariant; merge_modalities establishes it at
    bank build."""
    order = jnp.argsort(~live, axis=1, stable=True)
    return (
        jnp.take_along_axis(offs, order[..., None], axis=1),
        jnp.take_along_axis(oris, order, axis=1),
        jnp.take_along_axis(live, order, axis=1),
    )


@partial(jax.jit, static_argnames=("window", "coarse_T", "fine_T", "E0"))
def refine_candidates_slices(
    R0: jnp.ndarray,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int = 256,
    fine_T: int = 5,
    window: int = 24,
    anchor_min_y=0,
) -> Matches:
    """Refinement via contiguous window slices: a scan over feature slots,
    each step slicing one (window x window) response block per candidate
    (row-contiguous reads instead of 9M pointwise gathers).

    `anchor_min_y` replaces the lower clip bound of the row anchor — the
    row-sharded matcher passes its halo height so the image-top clipping
    happens at the GLOBAL frame edge, not at each shard's stripe start."""
    C, H, W = R0.shape
    K = cand.template_id.shape[0]
    Fmax = feats0.oris.shape[1]

    anchor_y = cand.cell_y * coarse_T * 2 - (fine_T - 1)
    anchor_x = cand.cell_x * coarse_T * 2 - (fine_T - 1)
    anchor_y = jnp.clip(anchor_y, anchor_min_y, H - 1)
    anchor_x = jnp.clip(anchor_x, 0, W - 1)

    t = cand.template_id
    offs = feats0.offsets[t]
    oris = feats0.oris[t]
    live = feats0.live[t]
    cnt = feats0.count[t]

    # Features may reach past the right/bottom image edge (E0 = max template
    # extent): zero padding makes those reads contribute nothing.
    pad = window + E0
    Rp = jnp.pad(R0, [(0, 0), (0, pad), (0, pad)])
    Hp, Wp = Rp.shape[1:]

    def slice_one(o, y, x):
        return jax.lax.dynamic_slice(Rp, (o, y, x), (1, window, window))[0]

    def body(acc, f):
        ys = jnp.clip(anchor_y + offs[:, f, 0], 0, Hp - window)
        xs = jnp.clip(anchor_x + offs[:, f, 1], 0, Wp - window)
        vals = jax.vmap(slice_one)(oris[:, f], ys, xs).astype(jnp.int32)
        vals = jnp.where(live[:, f][:, None, None], vals, 0)
        return acc + vals, None

    acc0 = jnp.zeros((K, window, window), jnp.int32)
    scores, _ = jax.lax.scan(body, acc0, jnp.arange(Fmax, dtype=jnp.int32))

    flat = scores.reshape(K, -1)
    rev = flat[:, ::-1]
    best = flat.shape[1] - 1 - jnp.argmax(rev, axis=1)
    raw = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    by = best // window
    bx = best % window
    sim = similarity(raw, cnt)
    ok = cand.valid & (sim >= threshold)
    return Matches(
        template_id=t, x=anchor_x + bx, y=anchor_y + by, similarity=sim, valid=ok
    )


@partial(jax.jit, static_argnames=("T", "E0"))
def walk_scores_xla(
    R0: jnp.ndarray,
    frame: jnp.ndarray,
    oris: jnp.ndarray,
    fy: jnp.ndarray,
    fx: jnp.ndarray,
    live: jnp.ndarray,
    slot_live: jnp.ndarray,
    gy0: jnp.ndarray,
    gx0: jnp.ndarray,
    T: int,
    E0: int,
) -> jnp.ndarray:
    """Raw walk scores (BK, 256) int32 as an XLA scan over feature slots —
    the plain form of ops.walk_triton.walk_scores_triton (same arguments,
    except that features are masked by `live` and skipped slots by
    `slot_live`, so it needs no contiguous-live precondition).

    Placements are stride-T, so on a (C, Hp/T, T, Wp/T, T) reshape of the
    padded response map one feature's 16x16 contributions are ONE
    contiguous (16,1,16,1) block: a dynamic_slice per (candidate, feature)."""
    Rp = walk_triton.pad_responses(R0, T, E0)
    B, C, Hp, Wp = Rp.shape
    Rr = Rp.reshape(B, C, Hp // T, T, Wp // T, T)
    BK, Fmax = oris.shape
    WIN = walk_triton.WIN

    def slice_one(b, o, Y, ry, X, rx):
        return jax.lax.dynamic_slice(
            Rr, (b, o, Y, ry, X, rx), (1, 1, WIN, 1, WIN, 1)
        ).reshape(WIN, WIN)

    def body(acc, f):
        vals = jax.vmap(slice_one)(
            frame, oris[:, f], gy0 + fy[:, f] // T, fy[:, f] % T,
            gx0 + fx[:, f] // T, fx[:, f] % T,
        ).astype(jnp.int32)
        return acc + jnp.where(live[:, f][:, None, None], vals, 0), None

    acc0 = jnp.zeros((BK, WIN, WIN), jnp.int32)
    scores, _ = jax.lax.scan(body, acc0, jnp.arange(Fmax, dtype=jnp.int32))
    return jnp.where(slot_live[:, None], scores.reshape(BK, -1), 0)


@partial(jax.jit, static_argnames=(
    "coarse_T", "fine_T", "E0", "total_hw", "triton_walk", "interpret"
))
def refine_candidates_opencv_batched(
    R0: jnp.ndarray,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int,
    fine_T: int = 5,
    total_hw: tuple[int, int] | None = None,
    y_origin=0,
    triton_walk: bool | None = None,
    interpret: bool = False,
    n_valid: jnp.ndarray | None = None,
) -> Matches:
    """cv::linemod's EXACT local-refinement walk, vectorized over (B, K)
    candidates — positions come out bit-identical to the genuine engine
    (verified against the libopencv_rgbd oracle in tests/test_oracle_parity).

    `n_valid` (B,) enables the live-prefix skip: slots >= n_valid[b] (the
    sub-threshold top-k filler, masked by `valid` downstream anyway) score
    an exact 0 instead of walking 256 placements x Fmax features — on real
    scenes that is ~2-4x less walk work.  The skip requires cand.valid to
    be a per-frame PREFIX (true for every similarity-sorted select); an
    in-graph guard widens any violating frame back to all K slots, so
    results never depend on the caller honoring the precondition.

    The walk (linemod matchClass, level-0 refinement pass):
      x1 = cell_x*T1 + (T1/2 + T1%2 - 1)      # coarse candidate, level-1 px
      x  = clamp(x1*2 + 1, 8*T0, W - tw - 8*T0)
      score the template at the 16x16 stride-T0 placements
          px = (x/T0 - 8 + c)*T0,  c in [0,16)   (same rows)
      first STRICT max in row-major order wins (r then c ascending), and the
      reported position is px + (T0/2 + T0%2 - 1).

    The placement scores come from walk_scores_xla or, where `triton_walk`,
    the Pallas-Triton kernel (ops.walk_triton); None lets ops.backend
    choose per lowering platform.  `interpret` runs the kernel in Pallas
    interpret mode (tests).  Both give the same int32 scores.

    Row-sharded callers pass GLOBAL cell indices in `cand`, the global frame
    dims as `total_hw`, and the global row of R0's first row as `y_origin`
    (a multiple of fine_T): the walk then clamps against the GLOBAL borders
    while reading the local stripe."""
    B, C, H, W = R0.shape
    K = cand.template_id.shape[1]
    Fmax = feats0.oris.shape[1]
    T = fine_T
    WIN = walk_triton.WIN
    off_f = T // 2 + (T % 2 - 1)
    wi = walk_inputs(feats0, cand, coarse_T, E0, fine_T, (H, W), total_hw,
                     y_origin, n_valid)

    @jax.named_scope("walk")
    def _xla_scores(_):
        return walk_scores_xla(R0, wi.frame, wi.oris, wi.fy, wi.fx, wi.live,
                               wi.slot_live, wi.gy0, wi.gx0, T, E0)

    @jax.named_scope("walk")
    def _triton_scores(_):
        return walk_triton.walk_scores_triton(
            R0, wi.frame, wi.oris, wi.fy, wi.fx,
            jnp.where(wi.slot_live, wi.count, 0), wi.gy0, wi.gx0,
            T=T, E0=E0, interpret=interpret,
        )

    def _guarded_triton(_):
        # The kernel walks features [0, nf), which requires live slots at
        # the front.  Rather than trust that precondition (a raw
        # dual-modality concat violated it), an in-graph lax.cond routes
        # banks with non-contiguous live slots through the live-masked XLA
        # scan — an exactness guard, not a device fallback; the check is
        # one elementwise compare and only the taken branch executes.
        contiguous = jnp.all(
            wi.live == (jnp.arange(Fmax, dtype=jnp.int32)[None, :]
                        < wi.count[:, None])
        )
        return jax.lax.cond(contiguous, _triton_scores, _xla_scores, None)

    impls = {"xla": _xla_scores, "triton": _guarded_triton}
    if triton_walk is None:
        flat = backend.by_platform(backend.WALK, impls, None)
    else:
        flat = impls["triton" if triton_walk else "xla"](None)
    best = jnp.argmax(flat, axis=1)  # first max == OpenCV's strict-> walk
    raw = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    sim = similarity(raw, wi.count)
    ok = cand.valid.reshape(-1) & (sim >= threshold)
    shp = lambda a: a.reshape(B, K)
    return Matches(
        template_id=shp(cand.template_id.reshape(-1)),
        x=shp(((wi.gx0 + best % WIN) * T + off_f).astype(jnp.int32)),
        y=shp(((wi.gy0 + best // WIN) * T + off_f + y_origin).astype(jnp.int32)),
        similarity=shp(sim),
        valid=shp(ok),
    )


class WalkInputs(NamedTuple):
    """Per-slot inputs of the level-0 walk over (B*K,) candidate slots
    (walk_scores_xla / ops.walk_triton.walk_scores_triton)."""

    frame: jnp.ndarray  # (BK,) frame of the slot
    oris: jnp.ndarray  # (BK, Fmax) orientation channel per feature
    fy: jnp.ndarray  # (BK, Fmax) feature rows, clipped to [0, E0]
    fx: jnp.ndarray  # (BK, Fmax) feature columns, clipped to [0, E0]
    live: jnp.ndarray  # (BK, Fmax) live feature slots
    count: jnp.ndarray  # (BK,) live feature count
    slot_live: jnp.ndarray  # (BK,) slot inside its frame's valid prefix
    gy0: jnp.ndarray  # (BK,) grid row of placement (0, 0)
    gx0: jnp.ndarray  # (BK,) grid column of placement (0, 0)


def walk_inputs(
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    E0: int,
    fine_T: int,
    frame_hw: tuple[int, int],
    total_hw: tuple[int, int] | None = None,
    y_origin=0,
    n_valid: jnp.ndarray | None = None,
) -> WalkInputs:
    """The walk's placement grid and features for (B, K) candidates (see
    refine_candidates_opencv_batched for the cv::linemod geometry)."""
    B, K = cand.template_id.shape
    T = fine_T
    off_c = coarse_T // 2 + (coarse_T % 2 - 1)
    border = 8 * T
    Ht, Wt = total_hw if total_hw is not None else frame_hw

    t = cand.template_id.reshape(-1)
    sz = feats0.size[t]  # (BK, 2) = (h, w) at level 0
    x = (cand.cell_x.reshape(-1) * coarse_T + off_c) * 2 + 1
    y = (cand.cell_y.reshape(-1) * coarse_T + off_c) * 2 + 1
    x = jnp.minimum(jnp.maximum(x, border), Wt - sz[:, 1] - border)
    y = jnp.minimum(jnp.maximum(y, border), Ht - sz[:, 0] - border)
    gx0 = jnp.maximum(x // T - 8, 0)
    gy0 = jnp.maximum(y // T - 8, 0) - y_origin // T

    if n_valid is None:
        nv = jnp.full((B,), K, jnp.int32)
    else:
        # Live-prefix guard: frames whose valid mask is NOT the sorted
        # prefix [0, n_valid) walk all K slots (elementwise compare — free).
        pref = jnp.all(
            cand.valid == (jnp.arange(K, dtype=jnp.int32)[None, :]
                           < n_valid[:, None]),
            axis=1,
        )
        nv = jnp.where(pref, n_valid.astype(jnp.int32), K)
    slot_live = (
        jnp.arange(K, dtype=jnp.int32)[None, :] < nv[:, None]
    ).reshape(-1)
    offs = feats0.offsets[t]
    return WalkInputs(
        frame=jnp.repeat(jnp.arange(B, dtype=jnp.int32), K),
        oris=feats0.oris[t],
        fy=jnp.clip(offs[..., 0], 0, E0),
        fx=jnp.clip(offs[..., 1], 0, E0),
        live=feats0.live[t],
        count=feats0.count[t],
        slot_live=slot_live,
        gy0=gy0,
        gx0=gx0,
    )


def refine_candidates_opencv(
    R0: jnp.ndarray,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int,
    fine_T: int = 5,
) -> Matches:
    """Single-frame wrapper over refine_candidates_opencv_batched."""
    m = refine_candidates_opencv_batched(
        R0[None], feats0, CoarseMatches(*(a[None] for a in cand)),
        coarse_T, threshold, E0, fine_T,
    )
    return Matches(*(a[0] for a in m))


@partial(jax.jit, static_argnames=("window", "coarse_T", "fine_T", "E0"))
def refine_candidates_conv(
    R0: jnp.ndarray,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int,
    fine_T: int = 5,
    window: int = 24,
) -> Matches:
    """Conv refinement: per-candidate response patches convolved with
    scatter-built one-hot filters of the candidates' level-0 features
    (batch-grouped conv: candidate k's patch sees only filter k).

    Equivalent to refine_candidates; avoids the giant elementwise gather.
    """
    C, H, W = R0.shape
    K = cand.template_id.shape[0]

    anchor_y = cand.cell_y * coarse_T * 2 - (fine_T - 1)
    anchor_x = cand.cell_x * coarse_T * 2 - (fine_T - 1)
    anchor_y = jnp.clip(anchor_y, 0, H - 1)
    anchor_x = jnp.clip(anchor_x, 0, W - 1)

    t = cand.template_id
    # Per-candidate one-hot filters (K, C, E0, E0) from the bank's features.
    offs = feats0.offsets[t]
    oris = feats0.oris[t]
    live = feats0.live[t]
    cnt = feats0.count[t]
    dy = jnp.clip(offs[..., 0], 0, E0 - 1)
    dx = jnp.clip(offs[..., 1], 0, E0 - 1)
    fidx = oris * (E0 * E0) + dy * E0 + dx
    Wk = jnp.zeros((K, C * E0 * E0), jnp.int8)
    Wk = Wk.at[jnp.arange(K)[:, None], fidx].add(jnp.where(live, jnp.int8(1), jnp.int8(0)))
    Wk = Wk.reshape(K, C, E0, E0)

    # Per-candidate padded response patches (K, C, E0+window-1, ...).
    P = E0 + window - 1
    Rp = jnp.pad(R0, [(0, 0), (0, P), (0, P)]).astype(jnp.int8)

    def patch(ay, ax):
        return jax.lax.dynamic_slice(Rp, (0, ay, ax), (C, P, P))

    patches = jax.vmap(patch)(anchor_y, anchor_x)  # (K, C, P, P)

    # Batch-grouped conv: candidate k's patch x filter k -> (K, window, window).
    scores = jax.lax.conv_general_dilated(
        patches,
        Wk,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        batch_group_count=K,
        preferred_element_type=jnp.int32,
    )
    # Output layout: (1, K, window, window).
    scores = scores.reshape(K, window, window)

    # Mask window offsets that run out of the original image: a feature read
    # past (H, W) must contribute 0 — the zero padding already ensures that,
    # and template-fit masking happens at the caller via position_validity.
    flat = scores.reshape(K, -1)
    rev = flat[:, ::-1]
    best = flat.shape[1] - 1 - jnp.argmax(rev, axis=1)
    raw = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    by = best // window
    bx = best % window
    sim = similarity(raw, cnt)
    ok = cand.valid & (sim >= threshold)
    return Matches(
        template_id=t, x=anchor_x + bx, y=anchor_y + by, similarity=sim, valid=ok
    )


def position_validity(size: jnp.ndarray, T: int, Hc: int, Wc: int) -> jnp.ndarray:
    """(N, Hc, Wc) bool — window position (i, j) keeps the template in-bounds."""
    ii = jax.lax.broadcasted_iota(jnp.int32, (Hc, Wc), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (Hc, Wc), 1)
    h = size[:, 0][:, None, None]
    w = size[:, 1][:, None, None]
    return (ii[None] * T + h <= Hc * T) & (jj[None] * T + w <= Wc * T)


class CoarseMatches(NamedTuple):
    template_id: jnp.ndarray  # (K,) int32
    cell_y: jnp.ndarray  # (K,) int32 (coarse grid row)
    cell_x: jnp.ndarray  # (K,)
    similarity: jnp.ndarray  # (K,) float32 percent
    valid: jnp.ndarray  # (K,) bool


@partial(jax.jit, static_argnames=("top_k",))
def select_candidates(
    raw: jnp.ndarray,
    total_features: jnp.ndarray,
    valid_pos: jnp.ndarray,
    threshold: float,
    top_k: int,
) -> CoarseMatches:
    """Threshold + top-k over the (N, Hc, Wc) coarse score volume."""
    N, Hc, Wc = raw.shape
    sim = similarity(raw, total_features[:, None, None])
    sim = jnp.where(valid_pos, sim, -1.0)
    flat = sim.reshape(-1)
    vals, idx = jax.lax.top_k(flat, min(top_k, flat.shape[0]))
    t = idx // (Hc * Wc)
    rem = idx % (Hc * Wc)
    cy = rem // Wc
    cx = rem % Wc
    ok = vals >= threshold
    return CoarseMatches(t.astype(jnp.int32), cy.astype(jnp.int32), cx.astype(jnp.int32), vals, ok)


class Matches(NamedTuple):
    """Final refined matches — the analog of cv::linemod::Match records."""

    template_id: jnp.ndarray  # (K,)
    x: jnp.ndarray  # (K,) full-res template-origin column
    y: jnp.ndarray  # (K,)
    similarity: jnp.ndarray  # (K,) float32 percent
    valid: jnp.ndarray  # (K,) bool


@partial(jax.jit, static_argnames=("window", "coarse_T", "fine_T"))
def refine_candidates(
    R0: jnp.ndarray,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    fine_T: int = 5,
    window: int = 24,
) -> Matches:
    """Evaluate level-0 features over a `window`x`window` stride-1 region
    around each coarse candidate; keep the best offset (OpenCV
    similarityLocal + candidate update).

    Window coverage: a coarse cell at grid index i covers true level-0
    positions [i*2T .. i*2T + 2(T-1)+1] (forward, because spreading covers
    forward offsets), plus the level-0 plateau extends back by fine_T-1 —
    so anchor at i*2T - (fine_T - 1) with window >= 2*coarse_T + fine_T.
    """
    _, H, W = R0.shape
    K = cand.template_id.shape[0]
    Fmax = feats0.oris.shape[1]

    anchor_y = cand.cell_y * coarse_T * 2 - (fine_T - 1)
    anchor_x = cand.cell_x * coarse_T * 2 - (fine_T - 1)
    anchor_y = jnp.clip(anchor_y, 0, H - 1)
    anchor_x = jnp.clip(anchor_x, 0, W - 1)

    t = cand.template_id
    offs = feats0.offsets[t]  # (K, Fmax, 2)
    oris = feats0.oris[t]  # (K, Fmax)
    cnt = feats0.count[t]
    live = feats0.live[t]

    wy = jnp.arange(window, dtype=jnp.int32)
    wx = jnp.arange(window, dtype=jnp.int32)
    # Gather indices (K, Fmax, window, window)
    yy = anchor_y[:, None, None, None] + offs[..., 0][..., None, None] + wy[None, None, :, None]
    xx = anchor_x[:, None, None, None] + offs[..., 1][..., None, None] + wx[None, None, None, :]
    inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    yy = jnp.clip(yy, 0, H - 1)
    xx = jnp.clip(xx, 0, W - 1)
    oo = jnp.broadcast_to(oris[..., None, None], yy.shape)
    vals = R0[oo, yy, xx].astype(jnp.int32)
    vals = jnp.where(inb & live[..., None, None], vals, 0)
    scores = jnp.sum(vals, axis=1)  # (K, window, window)

    flat = scores.reshape(K, -1)
    # Orientation spreading covers forward offsets only, so equal-score
    # plateaus extend up to T-1 px toward the top-left of the true position;
    # take the LAST maximum (bottom-right plateau corner) to recover it.
    rev = flat[:, ::-1]
    best = flat.shape[1] - 1 - jnp.argmax(rev, axis=1)
    raw = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    by = best // window
    bx = best % window
    sim = similarity(raw, cnt)
    ok = cand.valid & (sim >= threshold)
    return Matches(
        template_id=t,
        x=anchor_x + bx,
        y=anchor_y + by,
        similarity=sim,
        valid=ok,
    )


# ---------------------------------------------------------------------------
# Frame preprocessing: quantize + spread + respond at both pyramid levels.
# ---------------------------------------------------------------------------


def stack_modalities(pyr: "FramePyramid", use_depth: bool):
    """(R0, R1) response stacks from a FramePyramid — channel-concatenated
    when the DepthNormal modality is on.  The ONE place the modality
    channel layout is defined for serving/bench/sharded paths (Detector
    keeps its flag-aware variant for color-off configurations)."""
    if use_depth:
        return (
            jnp.concatenate([pyr.grad_r0, pyr.norm_r0], axis=0),
            jnp.concatenate([pyr.grad_r1, pyr.norm_r1], axis=0),
        )
    return pyr.grad_r0, pyr.grad_r1


class FramePyramid(NamedTuple):
    """Response maps per level per modality (zeros when depth unused)."""

    grad_r0: jnp.ndarray  # (8, H, W) u8
    grad_r1: jnp.ndarray  # (8, H/2, W/2) u8
    norm_r0: jnp.ndarray
    norm_r1: jnp.ndarray


@partial(jax.jit, static_argnames=("T0", "T1", "use_depth", "weak_threshold"))
def preprocess_frame(
    rgb: jnp.ndarray,
    depth_mm: jnp.ndarray | None,
    T0: int = 5,
    T1: int = 8,
    use_depth: bool = False,
    weak_threshold: float = 10.0,
) -> FramePyramid:
    """RGB (H, W, 3) u8 [+ depth (H, W) mm] -> response-map pyramid.

    Level 1 inputs are pyrDown'd per channel (cv::linemod builds the source
    pyramid the same way); depth is decimated 2x (OpenCV subsamples depth).
    """
    respond = lambda q, T: F.response_maps(F.orientation_spread(q, T))

    q0, _ = F.quantize_color_gradient(rgb, weak_threshold)
    g_r0 = respond(q0, T0)

    rgb1 = jnp.stack(
        [F.pyr_down(rgb[..., c].astype(jnp.float32)) for c in range(rgb.shape[-1])], axis=-1
    )
    q1, _ = F.quantize_color_gradient(rgb1, weak_threshold)
    g_r1 = respond(q1, T1)

    if use_depth and depth_mm is not None:
        n0 = F.quantize_depth_normal(depth_mm)
        n_r0 = respond(n0, T0)
        # DepthNormalPyramid::pyrDown SUBSAMPLES the level-0 quantized
        # normals (probed: oracle quantize_level(1) == level0[::2, ::2]
        # exactly; re-quantizing downsampled depth only agrees ~82-86%).
        n1 = n0[::2, ::2]
        n_r1 = respond(n1, T1)
    else:
        n_r0 = jnp.zeros_like(g_r0)
        n_r1 = jnp.zeros_like(g_r1)
    return FramePyramid(g_r0, g_r1, n_r0, n_r1)


@partial(jax.jit, static_argnames=("T0", "T1", "use_depth", "weak_threshold"))
def preprocess_frames_batched(
    rgbs: jnp.ndarray,  # (B, H, W, 3) uint8
    depths_mm: jnp.ndarray | None,  # (B, H, W) f32 or None
    T0: int = 5,
    T1: int = 8,
    use_depth: bool = False,
    weak_threshold: float = 10.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched preprocess -> channel-stacked (R0, R1) response tensors
    ((B, C, H, W), (B, C, H/2, W/2); C = 16 with DepthNormal, else 8):
    preprocess_frame vmapped over the batch.
    """
    if use_depth and depths_mm is None:
        # A DepthNormal bank without depth is a caller error.
        raise ValueError(
            "use_depth=True requires depths_mm (B, H, W) in millimetres"
        )
    with jax.named_scope("preprocess"):
        return jax.vmap(
            lambda r, d: stack_modalities(
                preprocess_frame(r, d, T0=T0, T1=T1, use_depth=use_depth,
                                 weak_threshold=weak_threshold),
                use_depth,
            )
        )(rgbs, depths_mm if depths_mm is not None
          else jnp.zeros(rgbs.shape[:3], jnp.float32))
