"""The walk kernel (Pallas-Triton, interpret mode on CPU) against the XLA
scan, and the survivor-position GEMM against the exhaustive one."""

import jax.numpy as jnp
import numpy as np
import pytest

from linemod_pose_estimation.ops import match as M
from linemod_pose_estimation.ops import walk_triton as WT


@pytest.mark.parametrize(
    "H, W, C, Fmax, T, E0, skip",
    [
        (101, 133, 8, 63, 5, 40, False),   # odd frame dims
        (96, 128, 16, 126, 5, 56, False),  # dual-modality Fmax
        (120, 160, 16, 63, 5, 48, True),   # live-prefix skip
        (97, 131, 16, 126, 5, 64, True),   # odd dims, Fmax 126, skip
        (90, 120, 8, 63, 3, 30, True),     # another stride
    ],
)
def test_walk_triton_equals_xla(rng, H, W, C, Fmax, T, E0, skip):
    B, K = 2, 6
    BK = B * K
    R0 = jnp.asarray(rng.integers(0, 5, size=(B, C, H, W)).astype(np.uint8))
    frame = jnp.asarray(np.repeat(np.arange(B), K).astype(np.int32))
    oris = rng.integers(0, C, size=(BK, Fmax)).astype(np.int32)
    fy = rng.integers(0, E0 + 1, size=(BK, Fmax)).astype(np.int32)
    fx = rng.integers(0, E0 + 1, size=(BK, Fmax)).astype(np.int32)
    nf = rng.integers(0, Fmax + 1, size=(BK,)).astype(np.int32)
    nf[0] = Fmax
    live = np.arange(Fmax)[None, :] < nf[:, None]
    slot_live = (rng.random(BK) < 0.6) if skip else np.ones(BK, bool)
    gy0 = rng.integers(0, (H - 1) // T + 1, size=(BK,)).astype(np.int32)
    gx0 = rng.integers(0, (W - 1) // T + 1, size=(BK,)).astype(np.int32)
    ref = M.walk_scores_xla(
        R0, frame, jnp.asarray(oris), jnp.asarray(fy), jnp.asarray(fx),
        jnp.asarray(live), jnp.asarray(slot_live), jnp.asarray(gy0),
        jnp.asarray(gx0), T, E0,
    )
    got = WT.walk_scores_triton(
        R0, frame, jnp.asarray(oris), jnp.asarray(fy), jnp.asarray(fx),
        jnp.asarray(np.where(slot_live, nf, 0).astype(np.int32)),
        jnp.asarray(gy0), jnp.asarray(gx0), T=T, E0=E0, interpret=True,
    )
    assert got.shape == (BK, 256) and got.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert not np.asarray(got)[~slot_live].any()


def test_coarse_pos_equals_exhaustive_rows(rng):
    """The survivor-position GEMM returns, at each survivor, exactly the
    exhaustive GEMM's row for that position."""
    T, C, Kc = 8, 16, 4  # CTT = 1024
    B, H, W = 2, 80, 120
    Hc, Wc = H // T, W // T
    n, fmax = 24, 32
    Rb = jnp.asarray(rng.integers(0, 5, size=(B, C, H, W)).astype(np.uint8))
    offs = rng.integers(0, Kc * T, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, C, size=(n, fmax)).astype(np.int32)
    live = rng.random((n, fmax)) < 0.9
    feats = M.LevelFeatures(
        jnp.asarray(offs), jnp.asarray(oris), jnp.asarray(live),
        jnp.asarray(live.sum(axis=1).astype(np.int32)),
        jnp.asarray(np.full((n, 2), Kc * T, np.int32)),
    )
    Wg = M.build_gemm_weights(feats, C, T, Kc)
    p_idx = rng.integers(0, Hc * Wc, size=(B, 8)).astype(np.int32)
    full = np.asarray(M.coarse_scores_gemm_flat_batched(Rb, Wg, T, Kc))
    got = M.coarse_scores_gemm_flat_batched_pos(Rb, Wg, jnp.asarray(p_idx),
                                                T, Kc)
    assert got.shape == (B, 8, n) and got.dtype == jnp.int32
    np.testing.assert_array_equal(
        np.asarray(got), np.take_along_axis(full, p_idx[..., None], axis=1))
