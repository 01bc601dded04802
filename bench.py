"""Benchmark: RGB-D frames/sec for full-pyramid LINEMOD matching at 640x480
over the committed bank tiled to deployment scale, plus the end-to-end
detect+cascade latency.

    python bench.py [iters] [batch]

Runs on JAX's default device.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "fps", "extra": {...}}

HEADLINE: the PRODUCTION path on the REAL trained bank — the committed
2652-view banks (data/*.yml.gz: dual-modality ColorGradient+DepthNormal
when present, else ColorGradient) tiled to the 10k scale, matched over
bin-picking scenes (rendered views of the fitted mesh, data/box_fitted.stl,
planted on low-texture backgrounds with distractors), through exact
hierarchical pruning: one cell-max upper-bound GEMM -> survivor positions
-> exact int8 GEMM over survivors with the static weight matrix -> select
-> the cv::linemod refinement walk.  Exactness is equality-tested in
tests/test_prune.py and tests/test_pool.py; the bench also reports the
planted-object found-rate and the exhaustive-path fps on the same scenes.

EXTRAS: exhaustive real-bank fps, the RGB-only bank, single-frame fps, the
two-object config, and the end-to-end p50 detect+cascade latency.

The pipeline runs as stage-level jitted programs rather than one fused
program; chained async dispatches overlap.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BOX_STL = os.path.join(REPO, "data", "box_fitted.stl")


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _time(fn, iters, *args, label=""):
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    _log(f"{label}: warmup/compile {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


# ----------------------------------------------------------------------
# Real-bank headline


def _bank_paths(stems=("boxNew_rgbd", "boxNew_full")):
    """The committed reference-scale bank (templates, params); prefers
    RGB-D."""
    for stem in stems:
        tpl = os.path.join(REPO, "data", f"{stem}_templates.yml.gz")
        prm = os.path.join(REPO, "data", f"{stem}_params.yml.gz")
        if os.path.exists(tpl) and os.path.exists(prm):
            return tpl, prm
    return None, None


def _bench_real_bank(B, iters, extra):
    """The headline: production pruned path over the tiled real bank."""
    import jax
    import jax.numpy as jnp

    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.renderer import Renderer
    from linemod_pose_estimation.models.templates import TemplateBank
    from linemod_pose_estimation.ops import match as M
    from linemod_pose_estimation.utils.scenes import bin_picking_scenes, found_rate

    tpl, prm = _bank_paths()
    if tpl is None:
        return None
    t0 = time.perf_counter()
    det = Detector.read(tpl)
    extra["real_cold_start_load_s"] = round(time.perf_counter() - t0, 2)
    meta, glob = TemplateBank.read_params_yaml(prm)
    cid = det.class_ids[0]
    bank = det.bank(cid)
    p = det.params
    T0, T1 = p.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    E0 = bank.extent(0)
    use_depth = p.use_depth_normal
    C = 16 if use_depth else 8
    # m_cap 96: ~2x headroom over the mean survivor count on these scenes;
    # an overflow takes the in-graph exhaustive fallback (exact, slow).
    # LPE_BENCH_MCAP overrides for tuning runs.
    thr, top_k = 91.0, 128
    m_cap = int(os.environ.get("LPE_BENCH_MCAP", "96"))
    # Fine-stage (g=4 subcell bound) position cap; overflow falls back
    # in-graph to the coarse set.
    m2_cap = int(os.environ.get("LPE_BENCH_M2CAP", "48"))
    fine_g = 4

    n0 = bank.num_templates
    # tile UP to >= 10240 (LPE_BENCH_TILE overrides for smoke tests).
    tile_to = int(os.environ.get("LPE_BENCH_TILE", "10240"))
    reps = max(1, -(-tile_to // n0))
    N = ((n0 * reps + 127) // 128) * 128
    feats1 = M.tile_level_features(bank.merged_features(1), reps, N)
    feats0 = M.tile_level_features(bank.merged_features(0), reps, N)
    _log(f"real bank {n0} x {reps} -> {N} templates, Kc1={Kc1}, E0={E0}, "
         f"modalities={'RGB-D' if use_depth else 'RGB'}")

    W_gemm = M.build_gemm_weights(feats1, C, T1, Kc1)
    W_cell = M.build_cell_weights(feats1, C, T1, Kc1)
    W_fine = M.build_cell_weights_fine(feats1, C, T1, Kc1, fine_g)
    jax.block_until_ready((W_gemm, W_cell, W_fine))

    rng = np.random.default_rng(3)
    r = Renderer(BOX_STL, glob.width, glob.height, glob.focal_length_x,
                 glob.focal_length_y)
    frames, depths_np, truths = bin_picking_scenes(r, meta, B, glob.height, glob.width, rng)
    rgbs = jnp.asarray(frames)
    depths = jnp.asarray(depths_np)

    pre_b = jax.jit(lambda rgbs, depths: M.preprocess_frames_batched(
        rgbs, depths, T0=T0, T1=T1, use_depth=use_depth,
        weak_threshold=p.color.weak_threshold))
    Hc, Wc = glob.height // 2 // T1, glob.width // 2 // T1
    vpos = M.position_validity_flat(feats1.size, T1, Hc, Wc)
    # The production orchestrator: coarse bound -> fine subcell re-test ->
    # exact GEMM over fine survivors, with both in-graph exact fallbacks.
    orch_b = jax.jit(lambda Rb, Wg, Wc_, Wf, cnt, vp:
                     M.match_coarse_pruned_fine_with_fallback(
                         Rb, Wg, Wc_, Wf, cnt, vp, thr - 5.0, T1, Kc1,
                         fine_g, m_cap, m2_cap, top_k, Wc))
    coarse_ex = jax.jit(lambda Rb, W: M.coarse_scores_gemm_flat_batched(Rb, W, T1, Kc1))
    sel_ex = jax.jit(jax.vmap(
        lambda raw, cnt, vp: M.select_candidates_flat(raw, cnt, vp, thr - 5.0,
                                                      top_k, Wc),
        in_axes=(0, None, None)))
    # Every path passes the per-frame valid-prefix count into the walk:
    # similarity-sorted selects put valid candidates first, so the walk
    # skips the sub-threshold top-k filler; the in-graph prefix guard
    # makes this exact.
    refine_b = jax.jit(lambda R0, cand, f0: M.refine_candidates_opencv_batched(
        R0, f0, cand, T1, thr, E0=E0, fine_T=T0,
        n_valid=jnp.sum(cand.valid.astype(jnp.int32), axis=1)))
    refine_nv = jax.jit(lambda R0, cand, f0, nv: M.refine_candidates_opencv_batched(
        R0, f0, cand, T1, thr, E0=E0, fine_T=T0, n_valid=nv))
    # POOLED path (batch-shared survivor pool, per-frame fallback
    # granularity): the headline contender vs the per-frame-cap path.
    pool1 = int(os.environ.get("LPE_BENCH_POOL1", str(56 * B)))
    pool2 = int(os.environ.get("LPE_BENCH_POOL2", str(36 * B)))
    # Group-max pre-bound (build_group_bound): replaces the full (B, P, N)
    # bound GEMM + epilogue with a (B*P, N/group) one + a per-template
    # re-test at pooled positions only.  LPE_BENCH_GROUP=0 disables.
    grp = int(os.environ.get("LPE_BENCH_GROUP", "16"))
    gkw = {}
    if grp:
        W_grp, gcnt = M.build_group_bound(feats1, C, T1, Kc1, grp,
                                          W_cell=W_cell)
        jax.block_until_ready((W_grp, gcnt))
        gkw = dict(W_group=W_grp, group_counts=gcnt, group=grp,
                   pool0=int(os.environ.get("LPE_BENCH_POOL0",
                                            str(2 * pool1))))
    orch_pool = jax.jit(lambda Rb, Wg, Wc_, Wf, cnt, vp:
                        M.match_pooled_fine_with_fallback(
                            Rb, Wg, Wc_, Wf, cnt, vp, thr - 5.0, T1, Kc1,
                            fine_g, pool1, pool2, top_k, Wc, **gkw))

    def match_pruned(rgbs, depths, Wg=W_gemm, Wc=W_cell, Wf=W_fine):
        R0, R1 = pre_b(rgbs, depths)
        cand, _pp, _fp = orch_b(R1, Wg, Wc, Wf, feats1.count, vpos)
        return refine_b(R0, cand, feats0)

    def match_pooled(rgbs, depths, Wg=W_gemm, Wc=W_cell, Wf=W_fine):
        R0, R1 = pre_b(rgbs, depths)
        cand, nv, _st = orch_pool(R1, Wg, Wc, Wf, feats1.count, vpos)
        return refine_nv(R0, cand, feats0, nv)

    def match_ex(rgbs, depths):
        R0, R1 = pre_b(rgbs, depths)
        raw = coarse_ex(R1, W_gemm)
        cand = sel_ex(raw, feats1.count, vpos)
        return refine_b(R0, cand, feats0)

    dt_pool = _time(match_pooled, iters, rgbs, depths,
                    label=f"real_pooled_batch{B}")
    dt = _time(match_pruned, iters, rgbs, depths, label=f"real_pruned_batch{B}")
    extra["real_pooled_batch_fps"] = round(B / dt_pool, 2)
    extra["real_percap_batch_fps"] = round(B / dt, 2)
    # Headline = the faster of the two exact pruned paths (both equality-
    # gated below); the pooled path is expected to win once its pools are
    # tuned, but the measurement decides.  LPE_BENCH_HEADLINE forces the
    # selection (debug / smoke coverage of the losing path's plumbing).
    forced = os.environ.get("LPE_BENCH_HEADLINE")
    if forced == "pooled" or (forced is None and dt_pool <= dt):
        match_headline, extra["real_headline_path"] = match_pooled, "pooled"
        fps = B / dt_pool
    else:
        match_headline, extra["real_headline_path"] = match_pruned, "per_frame_caps"
        fps = B / dt
    if forced is None:
        fps = B / min(dt, dt_pool)
    dt_ex = _time(match_ex, max(iters // 2, 5), rgbs, depths,
                  label=f"real_exhaustive_batch{B}")
    # Found rates for BOTH exact pruned paths, not just the headline
    # winner: aliasing real_found_pruned to the headline would leave the
    # losing path (still a supported prune mode) with zero accuracy
    # validation in the artifact.
    m_pc = match_pruned(rgbs, depths)
    m_ex = match_ex(rgbs, depths)
    m_pl = match_pooled(rgbs, depths)
    ok_p, tot = found_rate(m_pc, truths)
    ok_e, _ = found_rate(m_ex, truths)
    ok_pl, _ = found_rate(m_pl, truths)
    R1_stats = pre_b(rgbs, depths)[1]
    _, pp, fp = orch_b(R1_stats, W_gemm, W_cell, W_fine, feats1.count, vpos)
    _, _, pst = orch_pool(R1_stats, W_gemm, W_cell, W_fine,
                          feats1.count, vpos)
    extra["real_bank_templates"] = int(N)
    extra["real_bank_modalities"] = "RGB-D" if use_depth else "RGB"
    extra["real_exhaustive_fps"] = round(B / dt_ex, 2)
    extra["real_found_pruned"] = f"{ok_p}/{tot}"
    extra["real_found_exhaustive"] = f"{ok_e}/{tot}"
    extra["real_found_pooled"] = f"{ok_pl}/{tot}"
    extra["real_found_headline"] = (
        extra["real_found_pooled"]
        if extra["real_headline_path"] == "pooled"
        else extra["real_found_pruned"]
    )
    extra["real_prune_pos_survivors_mean"] = round(
        float(np.asarray(pp.m_survivors).mean()), 1)
    extra["real_fine_pos_survivors_mean"] = round(
        float(np.asarray(fp.m_survivors).mean()), 1)
    extra["real_prune_overflow"] = bool(pp.overflow)
    extra["real_fine_overflow"] = bool(fp.overflow)
    extra["real_pool_coarse_total"] = int(pst.coarse_total)
    extra["real_pool_fine_total"] = int(pst.fine_total)
    extra["real_pool_caps"] = [pool1, pool2]
    extra["real_pool_fallback"] = bool(pst.fallback)
    # Single-frame latency through the HEADLINE production path (pool
    # capacities are per-batch totals, so the pooled variant re-jits with
    # pools scaled to B=1 — same per-frame slack as the headline config).
    if extra["real_headline_path"] == "pooled":
        gkw1 = dict(gkw, pool0=max(1, gkw["pool0"] // B)) if gkw else {}
        orch_pool1 = jax.jit(lambda Rb, Wg, Wc_, Wf, cnt, vp:
                             M.match_pooled_fine_with_fallback(
                                 Rb, Wg, Wc_, Wf, cnt, vp, thr - 5.0, T1,
                                 Kc1, fine_g, max(1, pool1 // B),
                                 max(1, pool2 // B), top_k, Wc, **gkw1))

        def match_single(rgbs, depths, Wg=W_gemm, Wc=W_cell, Wf=W_fine):
            R0, R1 = pre_b(rgbs, depths)
            cand, nv, _st = orch_pool1(R1, Wg, Wc, Wf, feats1.count, vpos)
            return refine_nv(R0, cand, feats0, nv)
    else:
        match_single = match_pruned
    dt1 = _time(match_single, iters, rgbs[:1], depths[:1],
                label=f"real_{extra['real_headline_path']}_single")
    extra["real_single_frame_fps"] = round(1.0 / dt1, 2)

    # Real-bank RGB-only pruned throughput (the round-3 comparison point:
    # same pruned path on the ColorGradient-only trained bank, C = 8).
    try:
        tpl_rgb, _ = _bank_paths(stems=("boxNew_full",))
        det_rgb = Detector.read(tpl_rgb)
        bank_rgb = det_rgb.bank(det_rgb.class_ids[0])
        Kc1r = bank_rgb.max_cell_extent(1)
        E0r = bank_rgb.extent(0)
        n0r = bank_rgb.num_templates
        repsr = max(1, -(-10240 // n0r))
        Nr = ((n0r * repsr + 127) // 128) * 128
        f1r = M.tile_level_features(bank_rgb.merged_features(1), repsr, Nr)
        f0r = M.tile_level_features(bank_rgb.merged_features(0), repsr, Nr)
        Wg_r = M.build_gemm_weights(f1r, 8, T1, Kc1r)
        Wc_r = M.build_cell_weights(f1r, 8, T1, Kc1r)
        jax.block_until_ready((Wg_r, Wc_r))
        pre_rgb = jax.jit(lambda rgbs, depths: M.preprocess_frames_batched(
            rgbs, depths, T0=T0, T1=T1, use_depth=False,
            weak_threshold=p.color.weak_threshold))
        vpos_r = M.position_validity_flat(f1r.size, T1, Hc, Wc)
        Wf_r = M.build_cell_weights_fine(f1r, 8, T1, Kc1r, fine_g)
        orch_r = jax.jit(lambda Rb, Wg, Wc_, Wf, cnt, vp:
                         M.match_coarse_pruned_fine_with_fallback(
                             Rb, Wg, Wc_, Wf, cnt, vp, thr - 5.0, T1, Kc1r,
                             fine_g, m_cap, m2_cap, top_k, Wc))
        refine_r = jax.jit(lambda R0, cand, f0: M.refine_candidates_opencv_batched(
            R0, f0, cand, T1, thr, E0=E0r, fine_T=T0,
            n_valid=jnp.sum(cand.valid.astype(jnp.int32), axis=1)))

        def match_rgb_real(rgbs, depths):
            R0, R1 = pre_rgb(rgbs, depths)
            cand, _pp, _fp = orch_r(R1, Wg_r, Wc_r, Wf_r, f1r.count, vpos_r)
            return refine_r(R0, cand, f0r)

        dt_r = _time(match_rgb_real, iters, rgbs, depths,
                     label=f"real_rgb_pruned_batch{B}")
        extra["real_rgb_bank_templates"] = int(Nr)
        extra["real_rgb_pruned_batch_fps"] = round(B / dt_r, 2)
        mr = match_rgb_real(rgbs, depths)
        okr, totr = found_rate(mr, truths)
        extra["real_rgb_found"] = f"{okr}/{totr}"
        del Wg_r, Wc_r, Wf_r, f1r, f0r  # release before the merged 2-class pass
    except Exception as e:  # pragma: no cover
        extra["real_rgb_error"] = str(e)[:200]

    # Two-object config on the MERGED multi-class path (BASELINE thresholds
    # 92/94): cv::linemod scores every class in one Detector::match call
    # (rgbdDetector.cpp:31-34) while the reference's two-object service
    # alternates two single-class detectors; here both classes (each the
    # full tiled real bank) share ONE preprocess -> ONE pooled prune (at
    # min(thresholds)) -> ONE pooled survivor GEMM over the concatenated
    # template axis -> ONE walk over the MERGED per-frame valid prefix
    # (merge_candidates_sorted: walk cost follows the total valid count
    # across classes, not classes x top_k slots).  two_object_split_fps is
    # the alternator baseline: two sequential single-class dispatches of
    # the headline path.  Batch B is tried first, then 16 on
    # RESOURCE_EXHAUSTED.
    thr_a, thr_b = 92.0, 94.0
    f1m, bases = M.concat_level_features([feats1, feats1])
    f0m, _ = M.concat_level_features([feats0, feats0])
    W_gemm_m = M.build_gemm_weights(f1m, C, T1, Kc1)
    W_cell_m = M.build_cell_weights(f1m, C, T1, Kc1)
    W_fine_m = M.build_cell_weights_fine(f1m, C, T1, Kc1, fine_g)
    jax.block_until_ready((W_gemm_m, W_cell_m, W_fine_m))
    slices = ((0, N), (N, 2 * N))
    vpos_m = M.position_validity_flat(f1m.size, T1, Hc, Wc)
    merge_j = jax.jit(M.merge_candidates_sorted)

    def _two_object_try(B2):
        rgbs2, depths2 = rgbs[:B2], depths[:B2]
        # Weights/features as ARGUMENTS: closing over them embeds ~3 GB
        # of HLO constants.  Pools sized like the single-class path (the
        # margin pass is at min(thresholds), so survivors match the
        # loosest class).
        match_mc = jax.jit(lambda Rb, Wg, Wc_, Wf, cnt, vp:
                           M.match_pooled_multiclass(
                               Rb, Wg, Wc_, Wf, cnt, vp, slices,
                               (thr_a - 5.0, thr_b - 5.0), T1, Kc1, fine_g,
                               56 * B2, 36 * B2, top_k, Wc))
        refine_mc = jax.jit(lambda R0, cand, f0, nv:
                            M.refine_candidates_opencv_batched(
                                R0, f0, cand, T1, min(thr_a, thr_b), E0=E0,
                                fine_T=T0, n_valid=nv))

        def two_object_merged(rgbs, depths):
            R0, R1 = pre_b(rgbs, depths)
            cands, _nvs, _st = match_mc(R1, W_gemm_m, W_cell_m, W_fine_m,
                                        f1m.count, vpos_m)
            cat, nv = merge_j(cands)
            return refine_mc(R0, cat, f0m, nv)

        # The split baseline must not be handicapped by pool shapes sized
        # for the full batch: after a memory retry at B2 < B, the pooled
        # headline's jitted pools still carry 56*B/36*B rows, overstating
        # the split cost and inflating merged-vs-split.  Rebuild the
        # single-class matcher with pools scaled to B2 (the per-frame-cap
        # path is batch-agnostic and needs no rebuild).
        if B2 == B or extra.get("real_headline_path") == "per_frame_caps":
            split_fn = match_headline
        else:
            gkw2 = dict(gkw)
            if grp:
                gkw2["pool0"] = max(1, gkw["pool0"] * B2 // B)
            orch_pool2 = jax.jit(lambda Rb, Wg, Wc_, Wf, cnt, vp:
                                 M.match_pooled_fine_with_fallback(
                                     Rb, Wg, Wc_, Wf, cnt, vp, thr - 5.0,
                                     T1, Kc1, fine_g,
                                     max(1, pool1 * B2 // B),
                                     max(1, pool2 * B2 // B),
                                     top_k, Wc, **gkw2))

            def split_fn(rgbs, depths):
                R0, R1 = pre_b(rgbs, depths)
                cand, nv, _st = orch_pool2(R1, W_gemm, W_cell, W_fine,
                                           feats1.count, vpos)
                return refine_nv(R0, cand, feats0, nv)

        def two_object_split(rgbs, depths):
            return (split_fn(rgbs, depths), split_fn(rgbs, depths))

        dt_m = _time(two_object_merged, iters, rgbs2, depths2,
                     label=f"two_object_merged_batch{B2}")
        extra["two_object_batch_fps"] = round(B2 / dt_m, 2)
        extra["two_object_batch"] = B2
        dt_s = _time(two_object_split, iters, rgbs2, depths2,
                     label=f"two_object_split_batch{B2}")
        extra["two_object_split_fps"] = round(B2 / dt_s, 2)
        m2 = two_object_merged(rgbs2, depths2)
        ok2, tot2 = found_rate(m2, truths[:B2])
        extra["two_object_found"] = f"{ok2}/{tot2}"

    try:
        try:
            _two_object_try(B)
        except Exception as e:
            if "RESOURCE_EXHAUSTED" not in str(e) or B <= 16:
                raise
            _log(f"two-object at batch {B} exhausted device memory; retrying at 16")
            _two_object_try(16)
    except Exception as e:  # pragma: no cover
        extra["two_object_error"] = str(e)[:200]
    finally:
        # Free the ~3.3 GB merged-class weights UNCONDITIONALLY: when both
        # two-object attempts exhaust device memory, leaking them into the e2e
        # section starves it too (observed: e2e RESOURCE_EXHAUSTED only
        # after a two-object OOM).
        del W_gemm_m, W_cell_m, W_fine_m, f1m, f0m

    # End-to-end p50 on a REAL scene: match + the full cascade (voting,
    # NMS, orientation clustering, viewport re-render, two-stage ICP, HV)
    # against the real 2652-entry metadata.  On real scenes ICP early-stops
    # (the synthetic-noise e2e never converges and runs all 150 iters).
    try:
        p50, dev, pipe = _e2e_real_ms(match_headline, meta, glob, frames,
                                      depths_np, reps,
                                      weights=(W_gemm, W_cell, W_fine))
        extra["real_e2e_p50_ms"] = round(p50, 2)
        extra["real_e2e_device_ms"] = round(dev, 2)
        extra["real_e2e_pipelined_p50_ms"] = round(pipe, 2)
    except Exception as e:  # pragma: no cover
        extra["real_e2e_error"] = str(e)[:200]
    return fps, use_depth


def make_real_pose_stage(meta, glob, reps):
    """The production cascade as ONE callable (matches, cloud) -> (poses,
    valid): RCD voting + IoU NMS + orientation clustering + viewport
    re-render + point-to-plane ICP + HV against the real bank's metadata
    tiled `reps` times.  Shared by the e2e latency bench and the streaming
    bench (tools/bench_streaming.py)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from linemod_pose_estimation.models import cascade as CC
    from linemod_pose_estimation.models.renderer import _pad_triangles
    from linemod_pose_estimation.utils import geometry as geo
    from linemod_pose_estimation.utils.stl import load_stl

    mesh = load_stl(BOX_STL)
    tris = jnp.asarray(_pad_triangles(mesh.triangles.astype(np.float32), 64))
    K_render = jnp.array(
        [[glob.focal_length_x, 0, glob.width / 2.0],
         [0, glob.focal_length_y, glob.height / 2.0], [0, 0, 1.0]], jnp.float32,
    )
    # The production pose config: point-to-plane ICP (converges in ~3-9
    # iterations where the Kabsch two-stage needed 150+; same accuracy
    # config as ACCURACY.json, incl. symmetry disambiguation).
    p = CC.CascadeParams(canonicalize="none", icp_variant="point_to_plane",
                         orientation_hypotheses=2, nms_after_pose=True)
    # metadata tiled like the features (template ids may exceed n0)
    q_bank = jnp.tile(jnp.asarray(
        np.asarray(geo.quat_from_matrix(jnp.asarray(meta.R))), jnp.float32), (reps, 1))
    T_bank = jnp.tile(jnp.asarray(meta.T, jnp.float32), (reps, 1))
    D_bank = jnp.tile(jnp.asarray(meta.D, jnp.float32), (reps,))
    Od_bank = jnp.tile(jnp.asarray(meta.Ori_dist, jnp.float32), (reps,))
    Rect_bank = jnp.tile(jnp.asarray(meta.Rect, jnp.int32), (reps, 1))
    rmin, rstep = float(glob.radius_min), float(glob.radius_step)

    def pose_stage(matches, cloud):
        clusters = CC.cluster_matches(
            matches, Od_bank, Rect_bank, rmin, rstep, p.clustering_step,
            p.cluster_filter_thresh, p.max_cells, p.members_cap,
        )
        keep = CC.nms_iou(clusters, p.iou_threshold)
        alive = clusters.valid & keep
        order = jnp.argsort(-jnp.where(alive, clusters.score, -jnp.inf))[: p.max_clusters]
        midx = clusters.member_idx[order]
        f = partial(CC.rough_pose_and_refine, params=p,
                    render_wh=(glob.width, glob.height))
        from linemod_pose_estimation.ops.verification import depth_normals
        depth_mm_img = jnp.where(jnp.isfinite(cloud[..., 2]), cloud[..., 2], 0.0) * 1000.0
        snrm = depth_normals(depth_mm_img, K_render)
        poses = jax.vmap(
            lambda qq, T, D, Odd, x, y, sim, mv, cv, cs: f(
                qq, T, D, Odd, x, y, sim, mv, cv, cs,
                cloud=cloud, triangles=tris, K_render=K_render,
                scene_normals=snrm,
            )
        )(
            q_bank[matches.template_id[midx]], T_bank[matches.template_id[midx]],
            D_bank[matches.template_id[midx]], Od_bank[matches.template_id[midx]],
            matches.x[midx].astype(jnp.float32), matches.y[midx].astype(jnp.float32),
            matches.similarity[midx].astype(jnp.float32),
            clusters.member_valid[order], alive[order], clusters.score[order],
        )
        return poses.pose, poses.valid

    return pose_stage


def _e2e_real_ms(match_frames, meta, glob, frames, depths_np, reps, iters=15,
                 weights=None):
    import jax
    import jax.numpy as jnp

    from linemod_pose_estimation.ops import match as M
    from linemod_pose_estimation.utils import pointcloud as pcu

    K_render = jnp.array(
        [[glob.focal_length_x, 0, glob.width / 2.0],
         [0, glob.focal_length_y, glob.height / 2.0], [0, 0, 1.0]], jnp.float32,
    )
    pose_stage = make_real_pose_stage(meta, glob, reps)

    rgb1 = jnp.asarray(frames[:1])
    dep1 = jnp.asarray(depths_np[:1])
    cloud = pcu.depth_to_cloud(jnp.asarray(depths_np[0]) / 1000.0, jnp.asarray(K_render))

    # ONE jit for the whole frame: fusing match + slice + pose into a
    # single program is the serving shape and removes ~10 dispatches per
    # frame.
    Wg, Wc, Wf = weights

    @jax.jit
    def one_frame_fused(rgb, dep, cloud, Wg, Wc, Wf):
        m = match_frames(rgb, dep, Wg, Wc, Wf)
        m1 = M.Matches(*(a[0] for a in m))
        return pose_stage(m1, cloud)

    pose, valid = one_frame_fused(rgb1, dep1, cloud, Wg, Wc, Wf)
    jax.block_until_ready(pose)
    _log(f"real_e2e: {int(np.asarray(valid).sum())} verified hypotheses")
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(one_frame_fused(rgb1, dep1, cloud, Wg, Wc, Wf))
        ts.append((time.perf_counter() - t0) * 1e3)
    # Device time per frame: back-to-back dispatches, ONE block at the end
    # (the blocking p50 above adds one host round-trip per frame).
    t0 = time.perf_counter()
    for _ in range(iters):
        out = one_frame_fused(rgb1, dep1, cloud, Wg, Wc, Wf)
    jax.block_until_ready(out)
    device_ms = (time.perf_counter() - t0) / iters * 1e3
    # PIPELINED serving: two frames in flight (PipelinedRunner) — frame
    # t+1 dispatches before blocking on frame t, so the host round-trip
    # hides behind device compute.  This is the production serving shape;
    # p50 here is the steady-state blocking period per frame.
    from linemod_pose_estimation.models.serving import PipelinedRunner

    run = PipelinedRunner(one_frame_fused, depth=2)
    run.submit(rgb1, dep1, cloud, Wg, Wc, Wf)
    tp = []
    for _ in range(2 * iters):
        t0 = time.perf_counter()
        run.submit(rgb1, dep1, cloud, Wg, Wc, Wf)
        tp.append((time.perf_counter() - t0) * 1e3)
    run.drain()
    return (float(np.percentile(ts, 50)), float(device_ms),
            float(np.percentile(tp, 50)))


def main() -> None:
    from linemod_pose_estimation.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 32

    extra = {}
    real = None
    try:
        real = _bench_real_bank(B, iters, extra)
    except Exception as e:  # pragma: no cover — keep the JSON line
        extra["real_bank_error"] = str(e)[:300]
        _log(f"real-bank headline failed: {e}")
    extra["batch"] = B
    _emit(real, extra, B)


def _emit(real, extra, B=32) -> None:
    import jax

    dev = jax.devices()[0]
    extra["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}
    if real is not None:
        fps, use_depth = real
        mod = "rgbd" if use_depth else "rgb"
        metric = (f"linemod_{mod}_match_fps_640x480_real_bank_"
                  f"{extra['real_bank_templates']}templates_pruned_batch{B}")
        value = fps
    else:
        metric = f"linemod_match_fps_640x480_real_bank_batch{B}"
        value = 0.0
    print(json.dumps({"metric": metric, "value": round(value, 2),
                      "unit": "fps", "extra": extra}))


if __name__ == "__main__":
    main()
