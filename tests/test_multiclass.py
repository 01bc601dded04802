"""Merged multi-class matching == per-class matching, bit for bit.

cv::linemod scores every class in one Detector::match call; the merged
path (ops.match.concat_level_features + match_coarse_pruned_multiclass /
serving.MultiClassBatchedMatcher) must reproduce the per-class pruned
pipeline's results exactly — same survivor-superset argument, same
selection, same refinement walk.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from linemod_pose_estimation.ops import match as M


def _bank(n, fmax, extent, seed):
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, extent, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, 8, size=(n, fmax)).astype(np.int32)
    cnt = np.full((n,), fmax, np.int32)
    live = np.ones((n, fmax), bool)
    size = np.full((n, 2), extent, np.int32)
    return M.LevelFeatures(
        jnp.asarray(offs), jnp.asarray(oris), jnp.asarray(live),
        jnp.asarray(cnt), jnp.asarray(size),
    )


def _scene(seed, H=120, W=160):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
    return jnp.asarray(rgb)


@pytest.mark.parametrize("m_cap", [16, 2])  # 2 forces the overflow fallback
def test_multiclass_equals_per_class(m_cap):
    T0, T1, E1, E0 = 5, 8, 24, 48
    Kc = (E1 - 1) // T1 + 1
    H, W = 120, 160
    thr_a, thr_b = 85.0, 88.0
    top_k = 32
    fA = _bank(24, 14, E1, 0)
    fB = _bank(40, 14, E1, 1)
    f0A = _bank(24, 14, E0, 2)
    f0B = _bank(40, 14, E0, 3)

    rgb = _scene(7, H, W)
    pyr = M.preprocess_frame(rgb, None, T0=T0, T1=T1, use_depth=False)
    R0, R1 = M.stack_modalities(pyr, False)
    R0b, R1b = R0[None], R1[None]
    Hc, Wc = (H // 2) // T1, (W // 2) // T1

    # Per-class reference: pruned-with-fallback + walk refine per bank.
    per = []
    for f1, f0, thr in ((fA, f0A, thr_a), (fB, f0B, thr_b)):
        Wg = M.build_gemm_weights(f1, 8, T1, Kc)
        Wc_ = M.build_cell_weights(f1, 8, T1, Kc)
        vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
        cand, _ = M.match_coarse_pruned_with_fallback(
            R1b, Wg, Wc_, f1.count, vpos, thr - 5.0, T1, Kc, m_cap, top_k, Wc)
        per.append(M.refine_candidates_opencv_batched(
            R0b, f0, cand, T1, thr, E0=E0, fine_T=T0))

    # Merged path.
    f1m, bases = M.concat_level_features([fA, fB])
    f0m, bases0 = M.concat_level_features([f0A, f0B])
    assert bases == bases0 == (0, 24)
    Wg = M.build_gemm_weights(f1m, 8, T1, Kc)
    Wc_ = M.build_cell_weights(f1m, 8, T1, Kc)
    Wf = M.build_cell_weights_fine(f1m, 8, T1, Kc, 4)
    vpos = M.position_validity_flat(f1m.size, T1, Hc, Wc)
    cands, pp = M.match_coarse_pruned_multiclass(
        R1b, Wg, Wc_, Wf, f1m.count, vpos, ((0, 24), (24, 64)),
        (thr_a - 5.0, thr_b - 5.0), T1, Kc, m_cap, top_k, Wc)
    cat = M.CoarseMatches(*(jnp.concatenate(a, axis=1) for a in zip(*cands)))
    mm = M.refine_candidates_opencv_batched(
        R0b, f0m, cat, T1, min(thr_a, thr_b), E0=E0, fine_T=T0)

    for i, (ref, base, thr) in enumerate(((per[0], 0, thr_a), (per[1], 24, thr_b))):
        sl = lambda a: a[:, i * top_k:(i + 1) * top_k]
        got_valid = np.asarray(sl(mm.valid) & (sl(mm.similarity) >= thr))
        ref_valid = np.asarray(ref.valid)
        # Compare the VALID sets (padding slots may differ in garbage).
        def rows(m, valid, rebase):
            t = np.asarray(m if rebase is None else m)
            return t
        g = {(int(t) - base, int(x), int(y), float(s))
             for t, x, y, s, v in zip(
                 np.asarray(sl(mm.template_id)).ravel(),
                 np.asarray(sl(mm.x)).ravel(),
                 np.asarray(sl(mm.y)).ravel(),
                 np.asarray(sl(mm.similarity)).ravel(),
                 got_valid.ravel()) if v}
        r = {(int(t), int(x), int(y), float(s))
             for t, x, y, s, v in zip(
                 np.asarray(ref.template_id).ravel(),
                 np.asarray(ref.x).ravel(),
                 np.asarray(ref.y).ravel(),
                 np.asarray(ref.similarity).ravel(),
                 ref_valid.ravel()) if v}
        assert g == r, f"class {i}: merged != per-class ({len(g)} vs {len(r)})"


def test_multiclass_serving_wrapper():
    """MultiClassBatchedMatcher vs per-class BatchedMatcher on a trained
    two-class detector (rendered views of two meshes)."""
    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.renderer import Renderer
    from linemod_pose_estimation.models.serving import (
        BatchedMatcher, MultiClassBatchedMatcher)
    from linemod_pose_estimation.models.templates import (
        DetectorParams, TemplateBank)
    from linemod_pose_estimation.utils.stl import Mesh, box_triangles
    from conftest import BANK_PARAMS, BOX_STL

    meta, glob = TemplateBank.read_params_yaml(BANK_PARAMS)
    W, H = 320, 240
    det = Detector(DetectorParams())
    views = {}
    # The second class is a flat chip-sized cuboid, much smaller than the
    # box: bring its camera in so the silhouette is big enough to carry
    # >= 4 stable features.
    chip = Mesh.from_triangles(box_triangles((0.03, 0.02, 0.005)))
    for cid, mesh, tscale, vids in (
            ("box", BOX_STL, 1.0, (40, 700, 1400, 2000)),
            ("chip", chip, 0.3, (100, 900, 300, 1500))):
        r = Renderer(mesh, W, H, glob.focal_length_x / 2,
                     glob.focal_length_y / 2)
        for vid in vids:
            if len(views.get(cid, [])) >= 2:
                break
            out = r.render(meta.R[vid], meta.T[vid] * tscale)
            if det.add_template(np.asarray(out.rgb), np.asarray(out.mask), cid) >= 0:
                views.setdefault(cid, []).append(out)
        assert len(views.get(cid, [])) >= 1, f"no {cid} template extracted"

    rng = np.random.default_rng(4)
    scene = rng.integers(0, 60, size=(H, W, 3), dtype=np.uint8)
    out = views["box"][0]
    x, y, w, h = (int(v) for v in np.asarray(out.rect))
    sub = np.asarray(out.mask)[y:y + h, x:x + w] > 0
    scene[y:y + h, x + 9:x + 9 + w][sub] = np.asarray(out.rgb)[y:y + h, x:x + w][sub]
    rgbs = jnp.asarray(scene[None])

    thr = 85.0
    mc = MultiClassBatchedMatcher(det, ["box", "chip"], thr, batch=1,
                                  top_k=16, prune_pos_cap=64)
    got = mc.match_batch(rgbs)
    for cid in ("box", "chip"):
        bm = BatchedMatcher(det, cid, thr, batch=1, top_k=16, prune=True,
                            prune_pos_cap=64)
        ref = bm.match_batch(rgbs)
        g = {(int(t), int(x_), int(y_), float(s))
             for t, x_, y_, s, v in zip(
                 np.asarray(got[cid].template_id).ravel(),
                 np.asarray(got[cid].x).ravel(),
                 np.asarray(got[cid].y).ravel(),
                 np.asarray(got[cid].similarity).ravel(),
                 np.asarray(got[cid].valid).ravel()) if v}
        r = {(int(t), int(x_), int(y_), float(s))
             for t, x_, y_, s, v in zip(
                 np.asarray(ref.template_id).ravel(),
                 np.asarray(ref.x).ravel(),
                 np.asarray(ref.y).ravel(),
                 np.asarray(ref.similarity).ravel(),
                 np.asarray(ref.valid).ravel()) if v}
        assert g == r, f"{cid}: merged serving != per-class"
    # The planted box must be found by the merged path.
    assert any(v for v in np.asarray(got["box"].valid).ravel())


def test_multiclass_pooled_equals_per_frame_caps():
    """match_pooled_multiclass (batch-shared pool) == the per-frame-cap
    merged path == per-class, as valid sets, including the merged-sorted
    single-walk refinement."""
    T0, T1, E1, E0 = 5, 8, 24, 48
    Kc = (E1 - 1) // T1 + 1
    H, W = 120, 160
    thr_a, thr_b = 85.0, 88.0
    top_k = 32
    fA = _bank(24, 14, E1, 0)
    fB = _bank(40, 14, E1, 1)
    f0A = _bank(24, 14, E0, 2)
    f0B = _bank(40, 14, E0, 3)
    rgb = _scene(7, H, W)
    pyr = M.preprocess_frame(rgb, None, T0=T0, T1=T1, use_depth=False)
    R0, R1 = M.stack_modalities(pyr, False)
    R0b, R1b = R0[None], R1[None]
    Hc, Wc = (H // 2) // T1, (W // 2) // T1

    f1m, bases = M.concat_level_features([fA, fB])
    f0m, _ = M.concat_level_features([f0A, f0B])
    Wg = M.build_gemm_weights(f1m, 8, T1, Kc)
    Wc_ = M.build_cell_weights(f1m, 8, T1, Kc)
    Wf = M.build_cell_weights_fine(f1m, 8, T1, Kc, 4)
    vpos = M.position_validity_flat(f1m.size, T1, Hc, Wc)
    slices = ((0, 24), (24, 64))
    thrs = (thr_a - 5.0, thr_b - 5.0)

    # Per-frame-cap merged reference.
    cands_ref, _ = M.match_coarse_pruned_multiclass(
        R1b, Wg, Wc_, Wf, f1m.count, vpos, slices, thrs, T1, Kc, 64,
        top_k, Wc)
    cat_r, nv_r = M.merge_candidates_sorted(cands_ref)
    m_ref = M.refine_candidates_opencv_batched(
        R0b, f0m, cat_r, T1, min(thr_a, thr_b), E0=E0, fine_T=T0,
        n_valid=nv_r)
    ref_split = M.split_matches_by_class(m_ref, slices, top_k)

    # Pooled merged path.
    cands_p, nvs_p, stats = M.match_pooled_multiclass(
        R1b, Wg, Wc_, Wf, f1m.count, vpos, slices, thrs, T1, Kc, 4,
        pool1=256, pool2=128, top_k=top_k, Wc=Wc, r_cap=256)
    assert not bool(stats.fallback)
    cat_p, nv_p = M.merge_candidates_sorted(cands_p)
    m_p = M.refine_candidates_opencv_batched(
        R0b, f0m, cat_p, T1, min(thr_a, thr_b), E0=E0, fine_T=T0,
        n_valid=nv_p)
    got_split = M.split_matches_by_class(m_p, slices, top_k)

    def vset(m, thr):
        t, x, y, s, v = (np.asarray(a) for a in m)
        v = v & (s >= thr)
        return {(int(t[i]), int(x[i]), int(y[i]), round(float(s[i]), 4))
                for i in np.ndindex(v.shape) if v[i]}

    for i, thr in enumerate((thr_a, thr_b)):
        assert vset(got_split[i], thr) == vset(ref_split[i], thr)


def test_multiclass_pooled_serving_wrapper():
    """MultiClassBatchedMatcher(prune_mode='pooled') == default mode on a
    trained two-class detector."""
    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.renderer import Renderer
    from linemod_pose_estimation.models.serving import MultiClassBatchedMatcher
    from linemod_pose_estimation.models.templates import (
        DetectorParams, TemplateBank)
    from conftest import BANK_PARAMS, BOX_STL

    meta, glob = TemplateBank.read_params_yaml(BANK_PARAMS)
    W, H = 320, 240
    det = Detector(DetectorParams())
    r = Renderer(BOX_STL, W, H, glob.focal_length_x / 2,
                 glob.focal_length_y / 2)
    outs = []
    for vid in (40, 700):
        out = r.render(meta.R[vid], meta.T[vid])
        assert det.add_template(np.asarray(out.rgb), np.asarray(out.mask),
                                f"c{vid}") >= 0
        outs.append(out)

    rng = np.random.default_rng(4)
    scene = rng.integers(0, 60, size=(H, W, 3), dtype=np.uint8)
    out = outs[0]
    x, y, w, h = (int(v) for v in np.asarray(out.rect))
    sub = np.asarray(out.mask)[y:y + h, x:x + w] > 0
    scene[y:y + h, x + 9:x + 9 + w][sub] = np.asarray(out.rgb)[y:y + h, x:x + w][sub]
    rgbs = jnp.asarray(scene[None])

    thr = 85.0
    base = MultiClassBatchedMatcher(det, ["c40", "c700"], thr, batch=1,
                                    top_k=16, prune_pos_cap=64)
    pooled = MultiClassBatchedMatcher(det, ["c40", "c700"], thr, batch=1,
                                      top_k=16, prune_mode="pooled",
                                      pool_coarse=512, pool_fine=256,
                                      sel_row_cap=512)
    gb = base.match_batch(rgbs)
    gp = pooled.match_batch(rgbs)
    assert not bool(pooled.last_pool.fallback)

    def vset(m):
        t, x_, y_, s, v = (np.asarray(a) for a in m)
        return {(int(t[i]), int(x_[i]), int(y_[i]), round(float(s[i]), 4))
                for i in np.ndindex(v.shape) if v[i]}

    found_any = False
    for cid in ("c40", "c700"):
        assert vset(gp[cid]) == vset(gb[cid])
        found_any |= bool(np.asarray(gb[cid].valid).any())
    assert found_any
