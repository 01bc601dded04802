"""Exact hierarchical pruning (ops.match upper-bound GEMM + survivor
compaction) — equality-tested against the exhaustive engine.

The bound: responses are graded 0..4, so replacing every feature read with
the max response of its TxT cell upper-bounds the true raw score; any
template whose bound stays below the selection threshold at every valid
position can be discarded before the expensive exact GEMM with NO change to
the candidate set at that threshold (VERDICT round 2, item 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from linemod_pose_estimation.ops import match as M

T1 = 8
C = 16
EXT = 48
KC = (EXT - 1) // T1 + 1  # 6


def _bank(rng, n, fmax=126, ext=EXT, c=C):
    offs = rng.integers(0, ext, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, c, size=(n, fmax)).astype(np.int32)
    live = rng.random((n, fmax)) < 0.9
    cnt = live.sum(axis=1).astype(np.int32)
    size = np.full((n, 2), ext, np.int32)
    return M.LevelFeatures(
        jnp.asarray(offs), jnp.asarray(oris), jnp.asarray(live),
        jnp.asarray(cnt), jnp.asarray(size),
    )


def _frames(rng, b=2, h=160, w=160, sparse=0.6, hi=5):
    """Response batch 0..hi-1 with a sparse structure (zeros where a real
    scene is texture-free) so pruning has something to discard."""
    r = rng.integers(0, hi, size=(b, C, h, w)).astype(np.uint8)
    hole = rng.random((b, 1, h // T1, w // T1)) < sparse
    hole = np.repeat(np.repeat(hole, T1, axis=2), T1, axis=3)
    return jnp.asarray(np.where(hole, 0, r))


def _plant(Rb_np, feats, tid, b, py, px):
    """Write template `tid`'s live features into frame b at cell (py, px)
    with full response 4 -> exact sim 100 at that position."""
    offs = np.asarray(feats.offsets[tid])
    oris = np.asarray(feats.oris[tid])
    live = np.asarray(feats.live[tid])
    for f in np.flatnonzero(live):
        Rb_np[b, oris[f], py * T1 + offs[f, 0], px * T1 + offs[f, 1]] = 4
    return Rb_np


def _valid_set(cm, b=None):
    out = set()
    t, cy, cx, s, v = (np.asarray(a) for a in cm)
    it = np.ndindex(v.shape)
    for i in it:
        if v[i]:
            out.add((int(t[i]), int(cy[i]), int(cx[i]), round(float(s[i]), 4)))
    return out


def test_upper_bound_dominates_exact(rng):
    n = 32
    feats = _bank(rng, n)
    Rb = _frames(rng, b=2)
    W_rows = jnp.asarray(M.build_gemm_weights(feats, C, T1, KC)).T
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    exact = M.coarse_scores_gemm_flat_batched(Rb, W_rows.T, T1, KC)  # (B,P,N)
    ub = jnp.einsum(
        "bpk,nk->bpn",
        jnp.stack([M._ub_patches(R, T1, KC) for R in Rb]).astype(jnp.int32),
        W_cell.astype(jnp.int32),
    )
    assert bool(jnp.all(ub >= exact)), "cell-max bound must dominate"


def test_pruned_candidates_equal_exhaustive(rng):
    """Production-shaped scenario: weak sparse background responses + a few
    planted full-score matches, thresholded at 80 — planted templates (and
    any plateau neighbours) are valid in BOTH paths, everything else prunes.
    """
    n, top_k, thr = 64, 64, 80.0
    feats = _bank(rng, n)
    Rb_np = np.array(_frames(rng, b=2, sparse=0.5, hi=3))
    Rb_np = _plant(Rb_np, feats, tid=5, b=0, py=3, px=4)
    Rb_np = _plant(Rb_np, feats, tid=41, b=1, py=7, px=9)
    Rb = jnp.asarray(Rb_np)
    B, _, H, W = Rb.shape
    Hc, Wc = H // T1, W // T1
    W_gemm = M.build_gemm_weights(feats, C, T1, KC)  # (K, N)
    W_rows = jnp.asarray(W_gemm).T
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)

    raw = M.coarse_scores_gemm_flat_batched(Rb, W_gemm, T1, KC)
    ref = [
        M.select_candidates_flat(raw[b], feats.count, vpos, thr, top_k, Wc)
        for b in range(B)
    ]
    ref_sets = [_valid_set(r) for r in ref]
    assert any(len(s) for s in ref_sets), "test needs some valid candidates"
    assert all(len(s) < top_k for s in ref_sets), "top_k must not saturate"

    pr = M.prune_templates_batched(Rb, W_cell, feats.count, vpos, thr, T1, KC,
                                   n_cap=n)
    assert not bool(pr.overflow)
    n_surv = int(pr.n_survivors)
    assert 0 < n_surv < n, f"sparse frames should prune some templates ({n_surv}/{n})"
    raw_sub = M.coarse_scores_gemm_flat_batched_sub(Rb, W_rows, pr.idx, T1, KC)
    got = [
        M.select_candidates_flat_sub(raw_sub[b], feats.count, vpos, pr.idx,
                                     pr.keep, thr, top_k, Wc)
        for b in range(B)
    ]
    for b in range(B):
        assert _valid_set(got[b]) == ref_sets[b]


def test_survivors_superset_of_threshold_templates(rng):
    n, thr = 48, 50.0
    feats = _bank(rng, n)
    Rb = _frames(rng, b=1, sparse=0.4)
    Hc, Wc = Rb.shape[2] // T1, Rb.shape[3] // T1
    W_gemm = M.build_gemm_weights(feats, C, T1, KC)
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)
    raw = M.coarse_scores_gemm_flat_batched(Rb, W_gemm, T1, KC)[0]
    scale = 100.0 / (4.0 * np.maximum(np.asarray(feats.count), 1))
    sim = np.where(np.asarray(vpos), np.asarray(raw) * scale[None, :], -1.0)
    above = set(np.flatnonzero(sim.max(axis=0) >= thr).tolist())

    pr = M.prune_templates_batched(Rb, W_cell, feats.count, vpos, thr, T1, KC,
                                   n_cap=n)
    kept = set(np.asarray(pr.idx)[np.asarray(pr.keep)].tolist())
    assert above <= kept


def test_plan_two_axis_equals_exhaustive(rng):
    """Two-axis plan (positions x templates): the valid candidate set of the
    survivor-grid GEMM must equal the exhaustive engine's."""
    n, top_k, thr = 64, 64, 80.0
    feats = _bank(rng, n)
    Rb_np = np.array(_frames(rng, b=2, sparse=0.5, hi=3))
    Rb_np = _plant(Rb_np, feats, tid=5, b=0, py=3, px=4)
    Rb_np = _plant(Rb_np, feats, tid=41, b=1, py=7, px=9)
    Rb_np = _plant(Rb_np, feats, tid=41, b=0, py=8, px=2)  # two instances
    Rb = jnp.asarray(Rb_np)
    B, _, H, W = Rb.shape
    Hc, Wc = H // T1, W // T1
    W_gemm = M.build_gemm_weights(feats, C, T1, KC)
    W_rows = jnp.asarray(W_gemm).T
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)

    raw = M.coarse_scores_gemm_flat_batched(Rb, W_gemm, T1, KC)
    ref_sets = [
        _valid_set(M.select_candidates_flat(raw[b], feats.count, vpos, thr,
                                            top_k, Wc))
        for b in range(B)
    ]
    assert all(len(s) for s in ref_sets)

    plan = M.prune_plan_batched(Rb, W_cell, feats.count, vpos, thr, T1, KC,
                                n_cap=n, m_cap=Hc * Wc)
    assert not bool(plan.overflow)
    assert int(plan.m_survivors.max()) < Hc * Wc, "positions should prune"
    raw_sub = M.coarse_scores_gemm_flat_batched_sub2(
        Rb, W_rows, plan.t_idx, plan.p_idx, T1, KC)
    for b in range(B):
        got = M.select_candidates_flat_sub2(
            raw_sub[b], feats.count, vpos, plan.t_idx, plan.t_keep,
            plan.p_idx[b], plan.p_keep[b], thr, top_k, Wc)
        assert _valid_set(got) == ref_sets[b]


def test_position_only_equals_exhaustive(rng):
    """Position-only plan (static weights, no template gather — the
    production mode on real one-object banks): valid candidate set equals
    the exhaustive engine's."""
    n, top_k, thr = 64, 64, 80.0
    feats = _bank(rng, n)
    Rb_np = np.array(_frames(rng, b=2, sparse=0.5, hi=3))
    Rb_np = _plant(Rb_np, feats, tid=5, b=0, py=3, px=4)
    Rb_np = _plant(Rb_np, feats, tid=41, b=1, py=7, px=9)
    Rb_np = _plant(Rb_np, feats, tid=41, b=0, py=8, px=2)
    Rb = jnp.asarray(Rb_np)
    B, _, H, W = Rb.shape
    Hc, Wc = H // T1, W // T1
    W_gemm = M.build_gemm_weights(feats, C, T1, KC)
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)

    raw = M.coarse_scores_gemm_flat_batched(Rb, W_gemm, T1, KC)
    ref_sets = [
        _valid_set(M.select_candidates_flat(raw[b], feats.count, vpos, thr,
                                            top_k, Wc))
        for b in range(B)
    ]
    assert all(len(s) for s in ref_sets)

    plan = M.prune_positions_batched(Rb, W_cell, feats.count, vpos, thr, T1,
                                     KC, m_cap=Hc * Wc)
    assert not bool(plan.overflow)
    assert int(plan.m_survivors.max()) < Hc * Wc, "positions should prune"
    raw_sub = M.coarse_scores_gemm_flat_batched_pos(Rb, W_gemm, plan.p_idx,
                                                    T1, KC)
    for b in range(B):
        got = M.select_candidates_flat_pos(
            raw_sub[b], feats.count, vpos, plan.p_idx[b], plan.p_keep[b],
            thr, top_k, Wc)
        assert _valid_set(got) == ref_sets[b]


def test_plan_position_overflow_flag(rng):
    n = 32
    feats = _bank(rng, n)
    Rb = _frames(rng, b=1, sparse=0.0)  # dense: every position survives
    Hc, Wc = Rb.shape[2] // T1, Rb.shape[3] // T1
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)
    plan = M.prune_plan_batched(Rb, W_cell, feats.count, vpos, 10.0, T1, KC,
                                n_cap=n, m_cap=8)
    assert bool(plan.overflow)
    assert int(plan.m_survivors[0]) > 8


def test_overflow_flag_and_graceful_degradation(rng):
    n = 64
    feats = _bank(rng, n)
    Rb = _frames(rng, b=1, sparse=0.0)  # dense responses: everything survives
    Hc, Wc = Rb.shape[2] // T1, Rb.shape[3] // T1
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)
    pr = M.prune_templates_batched(Rb, W_cell, feats.count, vpos, 10.0, T1, KC,
                                   n_cap=16)
    assert bool(pr.overflow)
    assert int(pr.n_survivors) > 16
    assert int(np.asarray(pr.keep).sum()) == 16


def test_batched_matcher_prune_matches_exhaustive(rng):
    import sys

    sys.path.insert(0, "tests")
    from test_match import make_object_patch, plant

    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.serving import BatchedMatcher
    from linemod_pose_estimation.models.templates import DetectorParams

    patch, mask = make_object_patch(rng)
    det = Detector(DetectorParams(), engine="gather")
    for shift in (0, 3, 7):
        src = plant((120, 160, 3), patch, (30, 40 + shift))
        src_mask = plant((120, 160), mask, (30, 40 + shift))
        assert det.add_template(src, src_mask, "obj") >= 0

    frames = np.stack(
        [plant((120, 160, 3), patch, (30, 50)),
         plant((120, 160, 3), patch, (44, 62))]
    )
    base = BatchedMatcher(det, "obj", threshold=90.0, batch=2, top_k=16)
    fast = BatchedMatcher(det, "obj", threshold=90.0, batch=2, top_k=16,
                          prune=True, prune_cap=3)
    mb = base.match_batch(jnp.asarray(frames))
    mf = fast.match_batch(jnp.asarray(frames))
    assert not bool(fast.last_prune.overflow)
    vb, vf = np.asarray(mb.valid), np.asarray(mf.valid)
    for b in range(2):
        sb = {(int(t), int(x), int(y), round(float(s), 3))
              for t, x, y, s, v in zip(np.asarray(mb.template_id[b]),
                                       np.asarray(mb.x[b]), np.asarray(mb.y[b]),
                                       np.asarray(mb.similarity[b]), vb[b]) if v}
        sf = {(int(t), int(x), int(y), round(float(s), 3))
              for t, x, y, s, v in zip(np.asarray(mf.template_id[b]),
                                       np.asarray(mf.x[b]), np.asarray(mf.y[b]),
                                       np.asarray(mf.similarity[b]), vf[b]) if v}
        assert sb == sf and len(sb) > 0


def test_fallback_on_overflow_equals_exhaustive(rng):
    """match_coarse_pruned_with_fallback: when survivor positions exceed
    m_cap, the in-graph lax.cond must re-run the batch exhaustively so the
    valid candidate set STILL equals the exhaustive engine's (VERDICT
    round 3 item 4: no configuration may silently lose true detections).
    The reference scores every position unconditionally
    (rgbdDetector.cpp:31-34)."""
    n, top_k, thr = 64, 96, 80.0
    feats = _bank(rng, n)
    # Many planted full-score positions + a tiny cap -> guaranteed overflow.
    Rb_np = np.array(_frames(rng, b=2, sparse=0.5, hi=3))
    for b, (py, px) in [(0, (3, 4)), (0, (8, 2)), (0, (12, 11)), (0, (5, 13)),
                        (1, (7, 9)), (1, (2, 2)), (1, (10, 13)), (1, (13, 4))]:
        Rb_np = _plant(Rb_np, feats, tid=int(rng.integers(0, n)), b=b,
                       py=py, px=px)
    Rb = jnp.asarray(Rb_np)
    B, _, H, W = Rb.shape
    Hc, Wc = H // T1, W // T1
    W_gemm = M.build_gemm_weights(feats, C, T1, KC)
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)

    raw = M.coarse_scores_gemm_flat_batched(Rb, W_gemm, T1, KC)
    ref_sets = [
        _valid_set(M.select_candidates_flat(raw[b], feats.count, vpos, thr,
                                            top_k, Wc))
        for b in range(B)
    ]
    assert all(len(s) for s in ref_sets)

    m_cap = 2  # below the planted survivor count per frame
    plan_probe = M.prune_positions_batched(Rb, W_cell, feats.count, vpos, thr,
                                           T1, KC, m_cap)
    assert bool(plan_probe.overflow), "test must engineer an overflow"

    cands, plan = M.match_coarse_pruned_with_fallback(
        Rb, W_gemm, W_cell, feats.count, vpos, thr, T1, KC, m_cap, top_k, Wc)
    assert bool(plan.overflow)
    for b in range(B):
        got = _valid_set(M.CoarseMatches(*(a[b] for a in cands)))
        assert got == ref_sets[b], "fallback output must equal exhaustive"

    # And with ample cap the pruned branch runs and still agrees.
    cands2, plan2 = M.match_coarse_pruned_with_fallback(
        Rb, W_gemm, W_cell, feats.count, vpos, thr, T1, KC, Hc * Wc, top_k, Wc)
    assert not bool(plan2.overflow)
    for b in range(B):
        got = _valid_set(M.CoarseMatches(*(a[b] for a in cands2)))
        assert got == ref_sets[b]


def test_prune_int32_fallback_for_large_feature_counts(rng):
    """Banks whose total_features exceed int16 range (nf > 8191, or
    t_int > 32767) must keep the survivor plan equal to a plain int32 hand
    reference: the margin pass accumulates in int32, so large counts can
    never wrap.  Regression for the old int16 accumulation wrap."""
    n, thr = 32, 80.0
    feats = _bank(rng, n)
    Rb = jnp.asarray(_frames(rng, b=1, sparse=0.5, hi=3))
    _, _, H, W = Rb.shape
    Hc, Wc = H // T1, W // T1
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)

    small = M.prune_positions_batched(Rb, W_cell, feats.count, vpos, thr,
                                      T1, KC, m_cap=Hc * Wc)
    # Same bank, counts scaled x256 (well past the int16-safe 8191): the
    # integer thresholds scale by exactly 256 too, so eligibility — ub
    # being 4*count-scaled is NOT true for W_cell (weights unchanged), so
    # instead drive the int32 path and check it against a hand-computed
    # int32 reference margin.
    big_counts = feats.count.astype(jnp.int32) * 256
    big = M.prune_positions_batched(Rb, W_cell, big_counts, vpos, thr, T1,
                                    KC, m_cap=Hc * Wc)
    # Hand reference in plain int32.
    P_ub = M._ub_patches(Rb[0], T1, KC)
    ub = jnp.einsum("pk,nk->pn", P_ub.astype(jnp.int32),
                    W_cell.astype(jnp.int32))
    t_int = jnp.ceil((thr - 1e-3) * 0.04
                     * big_counts.astype(jnp.float32) - 1e-4).astype(jnp.int32)
    margin = jnp.where(vpos, ub - t_int[None, :], -(2 ** 30))
    p_score = jnp.max(margin, axis=1)
    ref_elig = set(np.flatnonzero(np.asarray(p_score) >= 0).tolist())
    got_elig = {
        int(p) for p, k in zip(np.asarray(big.p_idx[0]),
                               np.asarray(big.p_keep[0])) if k
    }
    assert got_elig == ref_elig
    assert int(big.m_survivors[0]) == len(ref_elig)
    # And the small-count bank matches its own int32 hand reference.
    t16 = jnp.ceil((thr - 1e-3) * 0.04
                   * feats.count.astype(jnp.float32) - 1e-4).astype(jnp.int32)
    m16 = jnp.where(vpos, ub - t16[None, :], -(2 ** 30))
    ref16 = set(np.flatnonzero(np.asarray(jnp.max(m16, axis=1)) >= 0).tolist())
    got16 = {
        int(p) for p, k in zip(np.asarray(small.p_idx[0]),
                               np.asarray(small.p_keep[0])) if k
    }
    assert got16 == ref16


def test_fine_bound_dominates_exact(rng):
    """g x g subcell max bound (stage 2) must dominate the exact raw score
    at every survivor position for every template."""
    n, thr, g = 32, 50.0, 4
    feats = _bank(rng, n)
    Rb = _frames(rng, b=2, sparse=0.5)
    B, _, H, W = Rb.shape
    Hc, Wc = H // T1, W // T1
    W_gemm = M.build_gemm_weights(feats, C, T1, KC)
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    W_fine = M.build_cell_weights_fine(feats, C, T1, KC, g)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)
    pp = M.prune_positions_batched(Rb, W_cell, feats.count, vpos, thr, T1,
                                   KC, m_cap=Hc * Wc)
    ubf = M.fine_ub_at_survivors(Rb, pp.p_idx, W_fine, T1, KC, g)
    exact = M.coarse_scores_gemm_flat_batched(Rb, W_gemm, T1, KC)  # (B,P,N)
    ex_at = jnp.take_along_axis(exact, pp.p_idx[:, :, None], axis=1)
    assert bool(jnp.all(ubf >= ex_at)), "fine bound must dominate exact"
    # and it must be tighter than (dominated by) the coarse cell-max bound
    ub_coarse = jnp.einsum(
        "bpk,nk->bpn",
        jnp.stack([M._ub_patches(R, T1, KC) for R in Rb]).astype(jnp.int32),
        M.build_cell_weights(feats, C, T1, KC).astype(jnp.int32))
    ubc_at = jnp.take_along_axis(ub_coarse, pp.p_idx[:, :, None], axis=1)
    assert bool(jnp.all(ubf <= ubc_at)), "fine bound must be tighter"


def test_fine_path_equals_exhaustive(rng):
    """Two-stage fine-position pruning: valid candidate set equals the
    exhaustive engine's, and the fine bound genuinely kills positions."""
    n, top_k, thr, g = 64, 64, 80.0, 4
    feats = _bank(rng, n)
    Rb_np = np.array(_frames(rng, b=2, sparse=0.5, hi=3))
    Rb_np = _plant(Rb_np, feats, tid=5, b=0, py=3, px=4)
    Rb_np = _plant(Rb_np, feats, tid=41, b=1, py=7, px=9)
    Rb_np = _plant(Rb_np, feats, tid=41, b=0, py=8, px=2)
    Rb = jnp.asarray(Rb_np)
    B, _, H, W = Rb.shape
    Hc, Wc = H // T1, W // T1
    W_gemm = M.build_gemm_weights(feats, C, T1, KC)
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    W_fine = M.build_cell_weights_fine(feats, C, T1, KC, g)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)

    raw = M.coarse_scores_gemm_flat_batched(Rb, W_gemm, T1, KC)
    ref_sets = [
        _valid_set(M.select_candidates_flat(raw[b], feats.count, vpos, thr,
                                            top_k, Wc))
        for b in range(B)
    ]
    assert all(len(s) for s in ref_sets)

    pp = M.prune_positions_batched(Rb, W_cell, feats.count, vpos, thr, T1,
                                   KC, m_cap=Hc * Wc)
    ubf = M.fine_ub_at_survivors(Rb, pp.p_idx, W_fine, T1, KC, g)
    fp_all = M.fine_plan_from_ub(ubf, feats.count, vpos, pp.p_idx,
                                 pp.p_keep, thr, m2_cap=Hc * Wc)
    n_coarse = int(pp.m_survivors.max())
    n_fine = int(fp_all.m_survivors.max())
    assert 0 < n_fine <= n_coarse, "fine bound must not add positions"

    cands, pp2, fp = M.match_coarse_pruned_fine_with_fallback(
        Rb, W_gemm, W_cell, W_fine, feats.count, vpos, thr,
        T1, KC, g, m_cap=Hc * Wc, m2_cap=Hc * Wc, top_k=top_k, Wc=Wc)
    assert not bool(pp2.overflow) and not bool(fp.overflow)
    # Compare the valid sets (the orchestrator selects like production).
    for b in range(B):
        got = _valid_set(M.CoarseMatches(*(a[b] for a in cands)))
        assert got == ref_sets[b]


def test_fine_overflow_falls_back_coarse(rng):
    """m2_cap below the true fine-survivor count must flip
    FinePlan.overflow and take the coarse-survivor branch — output still
    equals exhaustive."""
    n, top_k, thr, g = 64, 64, 80.0, 4
    feats = _bank(rng, n)
    Rb_np = np.array(_frames(rng, b=2, sparse=0.5, hi=3))
    Rb_np = _plant(Rb_np, feats, tid=5, b=0, py=3, px=4)
    Rb_np = _plant(Rb_np, feats, tid=41, b=1, py=7, px=9)
    Rb_np = _plant(Rb_np, feats, tid=41, b=0, py=8, px=2)
    Rb = jnp.asarray(Rb_np)
    B, _, H, W = Rb.shape
    Hc, Wc = H // T1, W // T1
    W_gemm = M.build_gemm_weights(feats, C, T1, KC)
    W_cell = M.build_cell_weights(feats, C, T1, KC)
    W_fine = M.build_cell_weights_fine(feats, C, T1, KC, g)
    vpos = M.position_validity_flat(feats.size, T1, Hc, Wc)

    raw = M.coarse_scores_gemm_flat_batched(Rb, W_gemm, T1, KC)
    ref_sets = [
        _valid_set(M.select_candidates_flat(raw[b], feats.count, vpos, thr,
                                            top_k, Wc))
        for b in range(B)
    ]
    cands, pp, fp = M.match_coarse_pruned_fine_with_fallback(
        Rb, W_gemm, W_cell, W_fine, feats.count, vpos, thr,
        T1, KC, g, m_cap=Hc * Wc, m2_cap=1, top_k=top_k, Wc=Wc)
    assert bool(fp.overflow) and int(fp.m_survivors.max()) > 1
    for b in range(B):
        got = _valid_set(M.CoarseMatches(*(a[b] for a in cands)))
        assert got == ref_sets[b]
