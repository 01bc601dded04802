"""Batch-shared survivor POOL (ops.match.match_pooled_fine_with_fallback)
— per-frame fallback granularity with unconditional exactness.

The per-frame-cap planner trips its fallback when ANY frame exceeds the
cap (the whole batch pays the slow branch); the pool shares capacity
across the batch, so one engineered busy frame takes more slots while the
other frames' plans — and the dispatched GEMM shapes — are unchanged
(VERDICT round 4, item 2)."""

import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, "tests")
from test_prune import C, KC, T1, _bank, _frames, _plant, _valid_set

from linemod_pose_estimation.ops import match as M

G = 4


def _weights(feats):
    Wg = M.build_gemm_weights(feats, C, T1, KC)
    Wc = M.build_cell_weights(feats, C, T1, KC)
    Wf = M.build_cell_weights_fine(feats, C, T1, KC, G)
    return Wg, Wc, Wf


def _exhaustive(Rb, Wg, feats, vpos, thr, top_k, Wcc):
    import jax

    raw = M.coarse_scores_gemm_flat_batched(Rb, Wg, T1, KC)
    return jax.vmap(
        lambda r: M.select_candidates_flat(r, feats.count, vpos, thr, top_k, Wcc)
    )(raw)


def test_gather_windows_pooled_matches_direct(rng):
    B, Hy, Wx, Ct = 3, 10, 12, 128
    L = rng.integers(0, 5, size=(B, Hy, Wx, Ct)).astype(np.int8)
    K = 4
    Mn = 17
    frame = rng.integers(0, B, size=(Mn,)).astype(np.int32)
    r0 = rng.integers(0, Hy - K + 1, size=(Mn,)).astype(np.int32)
    c0 = rng.integers(0, Wx - K + 1, size=(Mn,)).astype(np.int32)
    L3 = jnp.asarray(L.reshape(B * Hy, Wx, Ct))
    got = np.asarray(M.gather_windows_pooled(
        L3, jnp.asarray(frame * Hy + r0), jnp.asarray(c0), K
    )).reshape(Mn, K, K, Ct)
    for m in range(Mn):
        want = L[frame[m], r0[m]:r0[m] + K, c0[m]:c0[m] + K]
        np.testing.assert_array_equal(got[m], want)


def test_gather_windows_pooled_zero_past_plane(rng):
    """Windows reaching past the stacked plane read zeros there."""
    G, Wx, Ct, K, Mn = 20, 12, 64, 4, 23
    L = rng.integers(1, 5, size=(G, Wx, Ct)).astype(np.int8)
    r0 = rng.integers(0, G - 1, size=(Mn,)).astype(np.int32)
    c0 = rng.integers(0, Wx - 1, size=(Mn,)).astype(np.int32)
    got = np.asarray(M.gather_windows_pooled(
        jnp.asarray(L), jnp.asarray(r0), jnp.asarray(c0), K
    )).reshape(Mn, K, K, Ct)
    Lp = np.pad(L, [(0, K), (0, K), (0, 0)])
    for m in range(Mn):
        np.testing.assert_array_equal(
            got[m], Lp[r0[m]:r0[m] + K, c0[m]:c0[m] + K])


def test_pooled_equals_exhaustive(rng):
    n = 64
    feats = _bank(rng, n)
    Rb = np.array(_frames(rng, b=3))
    for b, (tid, py, px) in enumerate([(3, 2, 4), (10, 7, 9), (40, 1, 11)]):
        Rb = _plant(Rb, feats, tid, b, py, px)
    Rb = jnp.asarray(Rb)
    Hc, Wcc = Rb.shape[2] // T1, Rb.shape[3] // T1
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wcc)
    Wg, Wc, Wf = _weights(feats)
    thr, top_k = 85.0, 64

    ex = _exhaustive(Rb, Wg, feats, vpos, thr, top_k, Wcc)
    cands, n_valid, stats = M.match_pooled_fine_with_fallback(
        Rb, Wg, Wc, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1=1024, pool2=512, top_k=top_k, Wc=Wcc, r_cap=512,
    )
    assert not bool(stats.fallback)
    assert _valid_set(cands) == _valid_set(ex)
    # n_valid is the per-frame valid-prefix length the walk skip consumes.
    np.testing.assert_array_equal(
        np.asarray(n_valid), np.asarray(cands.valid).sum(axis=1))
    # True survivor telemetry is per frame and uncapped.
    assert int(stats.coarse_total) == int(np.asarray(stats.coarse_m).sum())
    assert int(stats.fine_total) == int(np.asarray(stats.fine_m).sum())


def test_busy_frame_shares_pool_without_fallback(rng):
    """One frame carrying far more survivors than any per-frame cap would
    allow must neither overflow the pool nor disturb the other frames."""
    n = 48
    feats = _bank(rng, n)
    # Near-empty frames except frame 1, which gets many planted objects.
    Rb = np.zeros((3, C, 160, 160), np.uint8)
    Rb = _plant(Rb, feats, 5, 0, 3, 3)
    busy = [(t, 2 * (i % 7), 2 * (i // 7)) for i, t in enumerate(range(28))]
    for tid, py, px in busy:
        Rb = _plant(Rb, feats, tid, 1, py, px)
    Rb = _plant(Rb, feats, 7, 2, 9, 9)
    Rb = jnp.asarray(Rb)
    Hc, Wcc = Rb.shape[2] // T1, Rb.shape[3] // T1
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wcc)
    Wg, Wc, Wf = _weights(feats)
    thr, top_k = 85.0, 128

    ex = _exhaustive(Rb, Wg, feats, vpos, thr, top_k, Wcc)
    # Pool sized ~32/frame TOTAL: frame 1 alone holds more survivors than
    # that per-frame average, but the light frames donate their headroom.
    cands, n_valid, stats = M.match_pooled_fine_with_fallback(
        Rb, Wg, Wc, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1=96, pool2=96, top_k=top_k, Wc=Wcc, r_cap=96,
    )
    m = np.asarray(stats.coarse_m)
    assert m[1] > 32, "busy frame must exceed the per-frame pool average"
    assert m[0] <= 4 and m[2] <= 4, "light frames stay light"
    assert not bool(stats.fallback), (
        "a busy frame within batch-total capacity must not trip any "
        "fallback — that is the per-frame granularity this pool exists for"
    )
    assert _valid_set(cands) == _valid_set(ex)

    # The same scene through the per-frame-cap planner at the equivalent
    # average cap DOES overflow (the round-4 cliff this replaces).
    pp = M.prune_positions_batched(
        Rb, Wc, feats.count, vpos, thr, T1, KC, m_cap=32)
    assert bool(pp.overflow)


def test_pool_overflow_falls_back_exactly(rng):
    n = 32
    feats = _bank(rng, n)
    Rb = np.array(_frames(rng, b=2))
    for b in range(2):
        for i in range(6):
            Rb = _plant(Rb, feats, i, b, 2 * (i % 3), 2 * (i // 3))
    Rb = jnp.asarray(Rb)
    Hc, Wcc = Rb.shape[2] // T1, Rb.shape[3] // T1
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wcc)
    Wg, Wc, Wf = _weights(feats)
    thr, top_k = 80.0, 64

    ex = _exhaustive(Rb, Wg, feats, vpos, thr, top_k, Wcc)
    # Coarse-pool overflow -> the exhaustive fallback.
    cands, _, stats = M.match_pooled_fine_with_fallback(
        Rb, Wg, Wc, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1=4, pool2=4, top_k=top_k, Wc=Wcc, r_cap=64,
    )
    assert bool(stats.coarse_overflow) and bool(stats.fallback)
    assert _valid_set(cands) == _valid_set(ex)
    # Fine-pool overflow -> the CHEAP in-graph fallback (exact GEMM over
    # the coarse pool), NOT the exhaustive branch.
    cands, _, stats = M.match_pooled_fine_with_fallback(
        Rb, Wg, Wc, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1=1024, pool2=4, top_k=top_k, Wc=Wcc, r_cap=64,
    )
    assert bool(stats.fine_overflow) and not bool(stats.fallback)
    assert _valid_set(cands) == _valid_set(ex)


def test_select_row_cap_overflow_falls_back(rng):
    """A frame with more pool rows than r_cap must flag sel_overflow and
    still return the exhaustive-exact set."""
    n = 32
    feats = _bank(rng, n)
    Rb = np.zeros((2, C, 160, 160), np.uint8)
    for i in range(12):
        Rb = _plant(Rb, feats, i, 0, 2 * (i % 4), 2 * (i // 4))
    Rb = jnp.asarray(Rb)
    Hc, Wcc = Rb.shape[2] // T1, Rb.shape[3] // T1
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wcc)
    Wg, Wc, Wf = _weights(feats)
    thr, top_k = 85.0, 64

    ex = _exhaustive(Rb, Wg, feats, vpos, thr, top_k, Wcc)
    cands, _, stats = M.match_pooled_fine_with_fallback(
        Rb, Wg, Wc, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1=256, pool2=256, top_k=top_k, Wc=Wcc, r_cap=4,
    )
    assert bool(stats.sel_overflow) and bool(stats.fallback)
    assert _valid_set(cands) == _valid_set(ex)


def test_batched_matcher_pooled_mode(rng):
    """BatchedMatcher(prune_mode='pooled') agrees with the exhaustive
    matcher on real rendered templates (valid sets, bit-exact sims)."""
    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.serving import BatchedMatcher
    from linemod_pose_estimation.models.templates import DetectorParams

    from test_match import make_object_patch, plant

    patch, mask = make_object_patch(rng)
    src = plant((120, 160, 3), patch, (30, 50))
    src_mask = plant((120, 160), mask, (30, 50))
    det = Detector(DetectorParams(), engine="gather")
    assert det.add_template(src, src_mask, "obj") == 0

    frames = np.stack([src, plant((120, 160, 3), patch, (44, 62))])
    base = BatchedMatcher(det, "obj", threshold=90.0, batch=2, top_k=16)
    pooled = BatchedMatcher(det, "obj", threshold=90.0, batch=2, top_k=16,
                            prune=True, prune_mode="pooled",
                            pool_coarse=64, pool_fine=32)
    mb = base.match_batch(jnp.asarray(frames))
    mp = pooled.match_batch(jnp.asarray(frames))
    assert not bool(pooled.last_pool.fallback)

    def vset(m):
        t, x, y, s, v = (np.asarray(a) for a in m)
        return {(int(t[i]), int(x[i]), int(y[i]), round(float(s[i]), 4))
                for i in np.ndindex(v.shape) if v[i]}

    assert vset(mp) == vset(mb) != set()


def test_grouped_prebound_equals_ungrouped(rng):
    """The group-max pre-bound tier must reproduce the ungrouped pooled
    plan's results exactly (same eligible set re-tested per template), on
    planted scenes and with a group size that does not divide N."""
    n = 48
    feats = _bank(rng, n)
    Rb = np.array(_frames(rng, b=3))
    for b, (tid, py, px) in enumerate([(3, 2, 4), (10, 7, 9), (40, 1, 11)]):
        Rb = _plant(Rb, feats, tid, b, py, px)
    Rb = jnp.asarray(Rb)
    Hc, Wcc = Rb.shape[2] // T1, Rb.shape[3] // T1
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wcc)
    Wg, Wc, Wf = _weights(feats)
    thr, top_k = 85.0, 64
    group = 7  # deliberately not dividing n=48

    W_group, gcnt = M.build_group_bound(feats, C, T1, KC, group)
    # Group bound dominates every member's bound at every position.
    P_ub = jnp.stack([M._ub_patches(R, T1, KC) for R in Rb]).astype(jnp.int32)
    ub_n = jnp.einsum("bpk,nk->bpn", P_ub, Wc.astype(jnp.int32))
    ub_g = jnp.einsum("bpk,gk->bpg", P_ub, W_group.astype(jnp.int32))
    Ng = W_group.shape[0]
    ub_n_pad = jnp.pad(ub_n, [(0, 0), (0, 0), (0, Ng * group - n)])
    assert bool(jnp.all(
        ub_g >= ub_n_pad.reshape(*ub_n.shape[:2], Ng, group).max(axis=3)))

    base = M.match_pooled_fine_with_fallback(
        Rb, Wg, Wc, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1=512, pool2=256, top_k=top_k, Wc=Wcc, r_cap=512,
    )
    grp = M.match_pooled_fine_with_fallback(
        Rb, Wg, Wc, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1=512, pool2=256, top_k=top_k, Wc=Wcc, r_cap=512,
        W_group=W_group, group_counts=gcnt, pool0=1024, group=group,
    )
    assert not bool(grp[2].fallback)
    assert _valid_set(grp[0]) == _valid_set(base[0])
    np.testing.assert_array_equal(np.asarray(grp[1]), np.asarray(base[1]))
    # Plans agree on the TRUE survivor telemetry.
    np.testing.assert_array_equal(np.asarray(grp[2].coarse_m),
                                  np.asarray(base[2].coarse_m))

    # pool0 too small -> overflow -> exhaustive fallback, still exact.
    grp_of = M.match_pooled_fine_with_fallback(
        Rb, Wg, Wc, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1=512, pool2=256, top_k=top_k, Wc=Wcc, r_cap=512,
        W_group=W_group, group_counts=gcnt, pool0=4, group=group,
    )
    assert bool(grp_of[2].fallback)
    assert _valid_set(grp_of[0]) == _valid_set(base[0])
