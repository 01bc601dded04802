"""One-hot GEMM scoring must equal the gather-based reference path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linemod_pose_estimation.ops import match as M


def random_bank(rng, n, fmax=24, extent=30):
    offs = rng.integers(0, extent, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, 8, size=(n, fmax)).astype(np.int32)
    cnt = rng.integers(4, fmax + 1, size=(n,)).astype(np.int32)
    live = np.arange(fmax)[None, :] < cnt[:, None]
    size = np.full((n, 2), extent, np.int32)
    return M.LevelFeatures(
        offsets=jnp.asarray(offs), oris=jnp.asarray(oris), live=jnp.asarray(live),
        count=jnp.asarray(cnt), size=jnp.asarray(size),
    )


def random_R(rng, c, h, w):
    return jnp.asarray(rng.choice([0, 3, 4], size=(c, h, w)).astype(np.uint8))


def test_conv_coarse_equals_gather(rng):
    T, ext_px = 8, 30
    feats = random_bank(rng, 17)
    R = random_R(rng, 8, 72, 96)
    ref = M.coarse_scores(R, feats, T, ext_px // T + 1)
    W = M.build_dense_weights(feats, 8, 32)
    got = M.coarse_scores_conv(R, W, T)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_conv_coarse_merged_modalities(rng):
    feats_g = random_bank(rng, 9)
    feats_n = random_bank(rng, 9)
    Rg = random_R(rng, 8, 64, 64)
    Rn = random_R(rng, 8, 64, 64)
    merged, R = M.merge_modalities([feats_g, feats_n], [Rg, Rn])
    ref = M.coarse_scores(R, merged, 8, 5)
    W = M.build_dense_weights(merged, 16, 32)
    got = M.coarse_scores_conv(R, W, 8)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_conv_refine_equals_gather(rng):
    T1, T0 = 8, 5
    feats0 = random_bank(rng, 12, fmax=24, extent=56)
    R0 = random_R(rng, 8, 120, 160)
    cand = M.CoarseMatches(
        template_id=jnp.asarray(rng.integers(0, 12, 6).astype(np.int32)),
        cell_y=jnp.asarray(rng.integers(0, 4, 6).astype(np.int32)),
        cell_x=jnp.asarray(rng.integers(0, 6, 6).astype(np.int32)),
        similarity=jnp.full((6,), 90.0, jnp.float32),
        valid=jnp.ones((6,), bool),
    )
    ref = M.refine_candidates(R0, feats0, cand, T1, 50.0, fine_T=T0)
    got = M.refine_candidates_conv(R0, feats0, cand, T1, 50.0, E0=64, fine_T=T0)
    np.testing.assert_array_equal(np.asarray(ref.similarity), np.asarray(got.similarity))
    np.testing.assert_array_equal(np.asarray(ref.x), np.asarray(got.x))
    np.testing.assert_array_equal(np.asarray(ref.y), np.asarray(got.y))
    np.testing.assert_array_equal(np.asarray(ref.valid), np.asarray(got.valid))


def test_gemm_coarse_equals_gather(rng):
    T = 8
    feats = random_bank(rng, 17, fmax=24, extent=30)
    R = random_R(rng, 8, 72, 96)
    Kc = 30 // T + 1
    ref = M.coarse_scores(R, feats, T, Kc)
    Wg = M.build_gemm_weights(feats, 8, T, Kc)
    got = M.coarse_scores_gemm(R, Wg, T, Kc)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_gemm_coarse_merged_modalities(rng):
    feats_g = random_bank(rng, 9)
    feats_n = random_bank(rng, 9)
    Rg = random_R(rng, 8, 64, 64)
    Rn = random_R(rng, 8, 64, 64)
    merged, R = M.merge_modalities([feats_g, feats_n], [Rg, Rn])
    ref = M.coarse_scores(R, merged, 8, 5)
    Wg = M.build_gemm_weights(merged, 16, 8, 5)
    got = M.coarse_scores_gemm(R, Wg, 8, 5)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_slices_refine_equals_gather(rng):
    T1, T0 = 8, 5
    feats0 = random_bank(rng, 12, fmax=24, extent=56)
    R0 = random_R(rng, 8, 120, 160)
    cand = M.CoarseMatches(
        template_id=jnp.asarray(rng.integers(0, 12, 6).astype(np.int32)),
        cell_y=jnp.asarray(rng.integers(0, 7, 6).astype(np.int32)),
        cell_x=jnp.asarray(rng.integers(0, 9, 6).astype(np.int32)),
        similarity=jnp.full((6,), 90.0, jnp.float32),
        valid=jnp.ones((6,), bool),
    )
    ref = M.refine_candidates(R0, feats0, cand, T1, 50.0, fine_T=T0)
    got = M.refine_candidates_slices(R0, feats0, cand, T1, 50.0, E0=64, fine_T=T0)
    np.testing.assert_array_equal(np.asarray(ref.similarity), np.asarray(got.similarity))
    np.testing.assert_array_equal(np.asarray(ref.x), np.asarray(got.x))
    np.testing.assert_array_equal(np.asarray(ref.y), np.asarray(got.y))
    np.testing.assert_array_equal(np.asarray(ref.valid), np.asarray(got.valid))


def test_dense_weights_structure(rng):
    feats = random_bank(rng, 3, fmax=8, extent=10)
    W = np.asarray(M.build_dense_weights(feats, 8, 16))
    for n in range(3):
        cnt = int(feats.count[n])
        # Each live feature adds one count (duplicates keep multiplicity).
        for f in range(cnt):
            o = int(feats.oris[n, f])
            y = int(feats.offsets[n, f, 0])
            x = int(feats.offsets[n, f, 1])
            assert W[n, o, y, x] >= 1
        assert W[n].sum() == cnt


def test_flat_layout_paths_match_template_major(rng):
    """coarse_scores_gemm_flat / select_candidates_flat (position-major,
    N on the lane axis) must produce the same scores and candidate set as
    the template-major path."""
    import jax.numpy as jnp

    from linemod_pose_estimation.ops import match as M

    n, fmax, ext, T = 24, 16, 24, 8
    Kc = (ext - 1) // T + 1
    offs = rng.integers(0, ext, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, 8, size=(n, fmax)).astype(np.int32)
    cnt = rng.integers(8, fmax + 1, size=(n,)).astype(np.int32)
    live = np.arange(fmax)[None, :] < cnt[:, None]
    feats = M.LevelFeatures(
        offsets=jnp.asarray(offs), oris=jnp.asarray(oris), live=jnp.asarray(live),
        count=jnp.asarray(cnt), size=jnp.asarray(np.full((n, 2), ext, np.int32)),
    )
    R = jnp.asarray(rng.choice([0, 1, 2, 3, 4], size=(8, 64, 96)).astype(np.uint8))
    W = M.build_gemm_weights(feats, 8, T, Kc)

    raw_nhw = M.coarse_scores_gemm(R, W, T, Kc)
    raw_flat = M.coarse_scores_gemm_flat(R, W, T, Kc)
    Hc, Wc = raw_nhw.shape[1:]
    np.testing.assert_array_equal(
        np.asarray(raw_flat), np.asarray(raw_nhw).reshape(n, -1).T
    )

    vpos = M.position_validity(feats.size, T, Hc, Wc)
    a = M.select_candidates(raw_nhw, feats.count, vpos, 0.0, 16)
    vposf = M.position_validity_flat(feats.size, T, Hc, Wc)
    b = M.select_candidates_flat(raw_flat, feats.count, vposf, 0.0, 16, Wc)
    # Compare as sets of tuples
    # (similarity rounded — raw/(4c)*100 vs raw*(100/(4c)) differ by 1 ulp).
    rows = lambda c: sorted(
        (round(float(c.similarity[i]), 3), int(c.template_id[i]),
         int(c.cell_y[i]), int(c.cell_x[i]))
        for i in range(16)
    )
    assert rows(a) == rows(b)


def test_merge_modalities_compacts_live(rng):
    """cv::linemod stores up to 63 features per modality in 64-slot blocks,
    so a raw concat leaves dead slots interspersed; the Pallas walk kernel
    masks features by f < nf and would silently mis-score (measured: a few
    raw units per candidate on the real dual-modality bank).  The merge
    must compact live slots to the front while preserving the feature SET."""
    n, fmax = 7, 64
    fa = random_bank(rng, n, fmax=fmax, extent=30)
    fb = random_bank(rng, n, fmax=fmax, extent=30)
    # Block-pattern live like the real banks: [0, cnt) live, rest dead.
    merged, _ = M.merge_modalities(
        [fa, fb], [random_R(rng, 8, 16, 16)] * 2)
    live = np.asarray(merged.live)
    cnt = np.asarray(merged.count)
    contig = np.arange(live.shape[1])[None, :] < cnt[:, None]
    np.testing.assert_array_equal(live, contig)
    # Feature multiset preserved (with the modality ori shift).
    for t in range(n):
        def fset(offs, oris, lv, shift=0):
            return sorted(
                (int(offs[t, f, 0]), int(offs[t, f, 1]), int(oris[t, f]) + shift)
                for f in np.nonzero(np.asarray(lv[t]))[0]
            )
        want = fset(fa.offsets, fa.oris, fa.live) + [
            (y, x, o + 8) for (y, x, o) in fset(fb.offsets, fb.oris, fb.live)
        ]
        got = fset(merged.offsets, merged.oris, merged.live)
        assert sorted(want) == got


def test_walk_pallas_noncontiguous_live(rng):
    """The batched walk's Triton kernel (interpret mode) and XLA scan must
    agree bit-for-bit on a MERGED dual-modality bank (whose pre-compaction
    live pattern once mis-scored silently)."""
    T1, T0, E0 = 8, 5, 56
    fa = random_bank(rng, 10, fmax=32, extent=E0)
    fb = random_bank(rng, 10, fmax=32, extent=E0)
    Ra = random_R(rng, 8, 160, 192)
    Rb = random_R(rng, 8, 160, 192)
    merged, R0 = M.merge_modalities([fa, fb], [Ra, Rb])
    cand = M.CoarseMatches(
        template_id=jnp.asarray(rng.integers(0, 10, (2, 6)).astype(np.int32)),
        cell_y=jnp.asarray(rng.integers(0, 6, (2, 6)).astype(np.int32)),
        cell_x=jnp.asarray(rng.integers(0, 8, (2, 6)).astype(np.int32)),
        similarity=jnp.full((2, 6), 90.0, jnp.float32),
        valid=jnp.ones((2, 6), bool),
    )
    R0b = jnp.stack([R0, jnp.roll(R0, 3, axis=2)])
    mx = M.refine_candidates_opencv_batched(
        R0b, merged, cand, T1, 50.0, E0=E0, fine_T=T0, triton_walk=False)
    mp = M.refine_candidates_opencv_batched(
        R0b, merged, cand, T1, 50.0, E0=E0, fine_T=T0, triton_walk=True,
        interpret=True)
    for name, a, b in zip(mx._fields, mx, mp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_walk_cond_fallback_on_noncontiguous_live(rng):
    """A bank whose live slots are NOT compacted (hole punched directly,
    bypassing merge_modalities) must route the Triton walk through the
    in-graph XLA-scan guard — results still bit-equal."""
    T1, T0, E0 = 8, 5, 56
    feats = random_bank(rng, 8, fmax=24, extent=E0)
    live = np.asarray(feats.live).copy()
    live[:, 2] = False  # hole: slot 2 dead while slots >= cnt-1 stay live
    feats = feats._replace(live=jnp.asarray(live),
                           count=jnp.asarray(live.sum(axis=1).astype(np.int32)))
    R0b = jnp.stack([random_R(rng, 8, 160, 192)] * 2)
    cand = M.CoarseMatches(
        template_id=jnp.asarray(rng.integers(0, 8, (2, 5)).astype(np.int32)),
        cell_y=jnp.asarray(rng.integers(0, 6, (2, 5)).astype(np.int32)),
        cell_x=jnp.asarray(rng.integers(0, 8, (2, 5)).astype(np.int32)),
        similarity=jnp.full((2, 5), 90.0, jnp.float32),
        valid=jnp.ones((2, 5), bool),
    )
    mx = M.refine_candidates_opencv_batched(
        R0b, feats, cand, T1, 50.0, E0=E0, fine_T=T0, triton_walk=False)
    mp = M.refine_candidates_opencv_batched(
        R0b, feats, cand, T1, 50.0, E0=E0, fine_T=T0, triton_walk=True,
        interpret=True)
    for name, a, b in zip(mx._fields, mx, mp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
