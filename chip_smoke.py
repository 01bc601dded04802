#!/usr/bin/env python3
"""On-card smoke test of the LINEMOD match and pose path, on one GPU.

    python chip_smoke.py [--seed N] [--batch B] [--reps R] [--iters I]

Drives the production path through its normal entry points at deployment
width: the committed dual-modality bank (2652 views) tiled --reps times and
padded to a multiple of 128 templates, 640x480 RGB-D bin-picking scenes
made from --seed with the fitted mesh (data/box_fitted.stl), matched by
BatchedMatcher(prune_mode="pooled") and posed by PoseService ->
DetectionPipeline (voting, NMS, orientation clustering, re-render,
point-to-plane ICP, hypothesis verification).

Phases: device, bank, match (checks and stage times), walk (Triton kernel
against the XLA scan), forms (Detector's gather scan against its one-hot
GEMM), served (pose
requests, GPU against the CPU of the same process).  Every check that
fails is listed and the script exits non-zero without the result line.
With no GPU it exits non-zero at once: it never falls back to the CPU.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
Every measurement is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
THRESHOLD = 91.0  # served and batched match threshold (percent)
TOP_K = 128


class Checks:
    """Named pass/fail checks and measurements of one run."""

    def __init__(self):
        self.failed: list[str] = []
        self.record: dict = {}

    def check(self, name: str, ok: bool, detail: str = "") -> None:
        print(f"[{'PASS' if ok else 'FAIL'}] {name}" + (f": {detail}" if detail else ""),
              flush=True)
        if not ok:
            self.failed.append(name)

    def put(self, key: str, value) -> None:
        self.record[key] = value


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_compile(name: str, jitted, *args, **kw):
    """AOT-compile a jitted stage; prints compile seconds and
    compiled.memory_analysis().  Returns (compiled, seconds)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kw).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    mems = ", ".join(f"{f.split('_size')[0]} {getattr(mem, f, 0) / 2**20:.1f} MiB"
                     for f in fields) if mem is not None else "n/a"
    log(f"compile {name}: {dt:.2f} s; memory: {mems}")
    return compiled, dt


def time_ms(fn, *args, iters: int = 10) -> float:
    """Median wall ms of `fn(*args)` blocked per call (steady state)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def valid_set(m, b: int) -> set:
    """{(template id, x, y, similarity)} of frame b's valid matches."""
    t, x, y, s, v = (np.asarray(a[b]) for a in m)
    return {(int(t[i]), int(x[i]), int(y[i]), float(s[i]))
            for i in np.nonzero(v)[0]}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tiled_metadata(meta, reps: int, n: int):
    """Bank metadata tiled like the features (template ids past the
    original count map back modulo it) and edge-padded to n rows."""
    from linemod_pose_estimation.models.templates import TemplateMetadata

    def tile(a):
        a = np.concatenate([np.asarray(a)] * reps, axis=0)
        return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1),
                      mode="edge")

    return TemplateMetadata(R=tile(meta.R), T=tile(meta.T), K=tile(meta.K),
                            D=tile(meta.D), Ori_dist=tile(meta.Ori_dist),
                            Rect=tile(meta.Rect))


def load_bank(reps: int):
    """Detector with the committed RGB-D bank tiled to deployment scale."""
    from linemod_pose_estimation.models.detector import Detector

    det = Detector.read(os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz"))
    cid = det.class_ids[0]
    base = det.bank(cid)
    n0 = base.num_templates
    n = -(-n0 * reps // 128) * 128
    det.attach_bank(base.tiled(reps, n))
    return det, cid, n0, n


def run(args, ck: Checks, walk_interpret: bool = False) -> None:
    import jax
    import jax.numpy as jnp

    from linemod_pose_estimation.api.service import Frame, ObjectConfig, PoseService
    from linemod_pose_estimation.models import cascade as CC
    from linemod_pose_estimation.models.pipeline import DetectionPipeline
    from linemod_pose_estimation.models.renderer import Renderer
    from linemod_pose_estimation.models.serving import BatchedMatcher
    from linemod_pose_estimation.models.templates import TemplateBank
    from linemod_pose_estimation.ops import backend
    from linemod_pose_estimation.ops import features as F
    from linemod_pose_estimation.ops import match as M
    from linemod_pose_estimation.ops import walk_triton as WT
    from linemod_pose_estimation.utils import geometry as geo
    from linemod_pose_estimation.utils import pointcloud as pcu
    from linemod_pose_estimation.utils.scenes import bin_picking_scenes, found_rate

    cpu = jax.devices("cpu")[0]
    B, iters = args.batch, args.iters
    box_stl = os.path.join(REPO, "data", "box_fitted.stl")
    params_yml = os.path.join(REPO, "data", "boxNew_rgbd_params.yml.gz")

    # ---------------------------------------------------------------- bank
    t0 = time.perf_counter()
    det, cid, n0, N = load_bank(args.reps)
    meta, glob = TemplateBank.read_params_yaml(params_yml)
    ck.put("bank_load_s", time.perf_counter() - t0)
    bm = BatchedMatcher(det, cid, THRESHOLD, batch=B, top_k=TOP_K, prune=True,
                        prune_mode="pooled")
    jax.block_until_ready((bm.W1, bm.W_cell, bm.W_fine))
    T0, T1, Kc, E0 = bm.T0, bm.T1, bm.Kc1, bm.E0
    C = 16 if bm.use_depth else 8
    ck.put("bank", {"views": n0, "reps": args.reps, "templates": N, "Kc1": Kc,
                    "E0": E0, "C": C, "W_gemm_bytes": int(bm.W1.size)})
    log(f"bank: {n0} views x {args.reps} -> {N} templates; W_gemm "
        f"{bm.W1.shape} ({bm.W1.size / 2**30:.2f} GiB), Kc1={Kc}, E0={E0}")
    ck.check("bank templates", N % 128 == 0 and N >= n0 * args.reps, str(N))
    W_group, group_counts = M.build_group_bound(bm.feats1, C, T1, Kc, 16,
                                                W_cell=bm.W_cell)

    # -------------------------------------------------------------- scenes
    H, W = glob.height, glob.width
    renderer = Renderer(box_stl, W, H, glob.focal_length_x, glob.focal_length_y)
    rng = np.random.default_rng(args.seed)
    frames, depths_np, truths = bin_picking_scenes(renderer, meta, B, H, W, rng)
    rgbs, depths = jnp.asarray(frames), jnp.asarray(depths_np)

    # --------------------------------------------------------------- match
    Hc, Wc = H // 2 // T1, W // 2 // T1
    pre, ck.record["compile_preprocess_s"] = timed_compile(
        "preprocess", bm._pre, rgbs, depths)
    R0, R1 = pre(rgbs, depths)
    pool, ck.record["compile_match_pool_s"] = timed_compile(
        "match_pool", bm._match_pool, R1, bm.W1, bm.W_cell, bm.W_fine,
        bm.feats1, Hc=Hc, Wc=Wc)
    cands, nv, stats = pool(R1, bm.W1, bm.W_cell, bm.W_fine, bm.feats1)
    walk, ck.record["compile_walk_s"] = timed_compile(
        "walk", bm._refine_nv, R0, cands, bm.feats0, nv)
    m_pool = bm.match_batch(rgbs, depths)  # the normal entry point
    st = {k: np.asarray(v).tolist() for k, v in bm.last_pool._asdict().items()}
    ck.put("pool_stats", {k: st[k] for k in ("coarse_total", "fine_total",
                                             "coarse_overflow", "fine_overflow",
                                             "sel_overflow", "fallback")})
    log(f"pool: {ck.record['pool_stats']}")
    ok_f, tot = found_rate(m_pool, truths)
    ck.put("found_rate", [ok_f, tot])
    log(f"planted-object found-rate (fitted mesh vs committed bank): {ok_f}/{tot}")

    # Pooled == exhaustive on every frame.
    thr_sel = THRESHOLD - 5.0
    vpos = M.position_validity_flat(bm.feats1.size, T1, Hc, Wc)
    ex_coarse = jax.jit(lambda R, Wg: M.coarse_scores_gemm_flat_batched(R, Wg, T1, Kc))
    ex_sel = jax.jit(jax.vmap(lambda r, cnt, vp: M.select_candidates_flat(
        r, cnt, vp, thr_sel, TOP_K, Wc), in_axes=(0, None, None)))
    ex_walk = jax.jit(lambda R0_, c, f0: M.refine_candidates_opencv_batched(
        R0_, f0, c, T1, THRESHOLD, E0=E0, fine_T=T0,
        n_valid=jnp.sum(c.valid.astype(jnp.int32), axis=1)))

    def match_exhaustive(R0_, R1_):
        return ex_walk(R0_, ex_sel(ex_coarse(R1_, bm.W1), bm.feats1.count, vpos),
                       bm.feats0)

    m_ex = match_exhaustive(R0, R1)
    bad = [b for b in range(B) if valid_set(m_pool, b) != valid_set(m_ex, b)]
    n_valid = sum(len(valid_set(m_pool, b)) for b in range(B))
    ck.check("pooled == exhaustive, every frame", not bad,
             f"{B} frames, {n_valid} valid matches; differing frames {bad}")

    # GPU == CPU: response maps on 4 scenes (bit-equal uint8), matches of
    # 2 frames through a BatchedMatcher built on the CPU (exact).
    nb = min(4, B)
    pre_g = jax.jit(lambda r, d: M.preprocess_frames_batched(
        r, d, T0=T0, T1=T1, use_depth=True, weak_threshold=bm.weak))
    g0, g1 = pre_g(rgbs[:nb], depths[:nb])
    with jax.default_device(cpu):
        c0, c1 = pre_g(jnp.asarray(frames[:nb]), jnp.asarray(depths_np[:nb]))
    for lvl, g, c in (("level 0", g0, c0), ("level 1", g1, c1)):
        diff = int(np.sum(np.asarray(g) != np.asarray(c)))
        ck.check(f"response maps GPU == CPU, {lvl}", diff == 0,
                 f"{diff} of {np.asarray(g).size} uint8 differ (Precision.HIGHEST)")
    # Precision finding: the level-1 pyrDown at Precision.HIGH (TF32 here).
    ch = jnp.asarray(frames[:nb, ..., 0], jnp.float32)

    def pyr(x, prec):
        x = jax.vmap(lambda im: F._reflect_pad2d(im, 2))(x)
        out = F._conv1d_blocked_dec2(
            F._conv1d_blocked_dec2(x, F._PYR5, x.ndim - 1, prec),
            F._PYR5, x.ndim - 2, prec)
        return jnp.floor(out + 0.5)

    hi = jax.jit(lambda x: pyr(x, jax.lax.Precision.HIGH))(ch)
    hst = jax.jit(lambda x: pyr(x, jax.lax.Precision.HIGHEST))(ch)
    with jax.default_device(cpu):
        ref = jax.jit(lambda x: pyr(x, jax.lax.Precision.HIGHEST))(
            jnp.asarray(frames[:nb, ..., 0], jnp.float32))
    n_hi = int(np.sum(np.asarray(hi) != np.asarray(ref)))
    n_hst = int(np.sum(np.asarray(hst) != np.asarray(ref)))
    ck.put("pyrdown_mismatch_px", {"HIGH": n_hi, "HIGHEST": n_hst,
                                   "of": int(np.asarray(ref).size)})
    log(f"precision: pyrDown pixels != CPU: HIGH {n_hi}, HIGHEST {n_hst} "
        f"of {np.asarray(ref).size}")
    ck.check("pyrDown HIGHEST GPU == CPU", n_hst == 0)

    with jax.default_device(cpu):
        det_c, cid_c, _, _ = load_bank(args.reps)
        bm_c = BatchedMatcher(det_c, cid_c, THRESHOLD, batch=2, top_k=TOP_K,
                              prune=True, prune_mode="pooled")
        m_c = bm_c.match_batch(jnp.asarray(frames[:2]), jnp.asarray(depths_np[:2]))
        jax.block_until_ready(m_c)
    m_g2 = bm.match_batch(rgbs[:2], depths[:2]) if B != 2 else m_pool
    for b in range(2):
        sg, sc, s32 = valid_set(m_g2, b), valid_set(m_c, b), valid_set(m_pool, b)
        detail = f"{len(sg)} GPU, {len(sc)} CPU valid matches"
        if not sg == sc == s32:
            detail += (f"; GPU only {sorted(sg - sc)[:5]}, CPU only "
                       f"{sorted(sc - sg)[:5]}, batch-32 only {sorted(s32 - sg)[:5]}")
        ck.check(f"frame {b} matches GPU == CPU", sg == sc == s32, detail)
    del bm_c, det_c

    # Top-k on the GPU: what approx_max_k and lax.top_k lower to, and the
    # tie order the selects rely on (lower index first, as on the CPU).
    x = jax.random.normal(jax.random.PRNGKey(args.seed), (Hc * Wc * N,))
    ops = {}
    for name, f in (("approx_max_k", jax.lax.approx_max_k), ("top_k", jax.lax.top_k)):
        hlo = jax.jit(lambda v, f=f: f(v, TOP_K)).lower(x).compile().as_text()
        ops[name] = [k for k in ("ApproxTopK", "TopK", "topk", "sort") if k in hlo]
    av, ai = jax.lax.approx_max_k(x, TOP_K)
    ev, ei = jax.lax.top_k(x, TOP_K)
    exact = bool(np.array_equal(np.asarray(av), np.asarray(ev))
                 and np.array_equal(np.asarray(ai), np.asarray(ei)))
    ties = jnp.repeat(jnp.arange(Hc * Wc * N // 4, dtype=jnp.float32) % 97, 4)
    _, ti = jax.lax.top_k(ties, TOP_K)
    with jax.default_device(cpu):
        _, ti_c = jax.jit(lambda v: jax.lax.top_k(v, TOP_K))(np.asarray(ties))
    tie_ok = bool(np.array_equal(np.asarray(ti), np.asarray(ti_c)))
    ck.put("top_k", {"hlo_ops": ops, "approx_exact": exact, "ties_match_cpu": tie_ok})
    log(f"top-k on GPU: optimized HLO mentions {ops}; approx_max_k exact: "
        f"{exact}; lax.top_k tie order == CPU: {tie_ok}")
    ck.check("approx_max_k exact on GPU", exact)
    ck.check("lax.top_k ties resolve as on the CPU", tie_ok)

    # Stage times: each stage jitted alone on the real intermediates.
    g = bm.fine_g
    cnt = bm.feats1.count
    t_int = M.int_score_threshold(thr_sel, cnt).astype(jnp.int32)
    P2 = min(bm.pool_fine, bm.pool_coarse)
    st_coarse = jax.jit(lambda R: M.pool_plan_from_margins(
        M.position_margins_batched(R, bm.W_cell, cnt, vpos, thr_sel, T1, Kc),
        bm.pool_coarse))
    pp = st_coarse(R1)
    st_fine = jax.jit(lambda R, p: M.fine_pool(R, p, bm.W_fine, t_int, vpos,
                                               T1, Kc, g, P2))
    frame2, pos2, keep2, starts2, fine_m, _ = st_fine(R1, pp)
    st_patch = jax.jit(lambda R, f, p: M.pooled_patches(R, f, p, T1, Kc))
    P_sub = st_patch(R1, frame2, pos2)
    st_dot = jax.jit(lambda A, Wg: jax.lax.dot_general(
        A, Wg, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    raw = st_dot(P_sub, bm.W1)
    st_sel = jax.jit(lambda r, f, p, k, s, m: M.select_candidates_pooled(
        r, cnt, vpos, f, p, k, s, m, thr_sel, TOP_K, Wc, bm.sel_row_cap))
    walk_x = jax.jit(lambda R0_, c, f0, n: M.refine_candidates_opencv_batched(
        R0_, f0, c, T1, THRESHOLD, E0=E0, fine_T=T0, triton_walk=False,
        n_valid=n))
    stage_ms = {
        "preprocess": time_ms(pre, rgbs, depths, iters=iters),
        "coarse": time_ms(st_coarse, R1, iters=iters),
        "fine": time_ms(st_fine, R1, pp, iters=iters),
        "patches": time_ms(st_patch, R1, frame2, pos2, iters=iters),
        "survivor_dot": time_ms(st_dot, P_sub, bm.W1, iters=iters),
        "select": time_ms(st_sel, raw, frame2, pos2, keep2, starts2, fine_m,
                          iters=iters),
        "walk_triton": time_ms(walk, R0, cands, bm.feats0, nv, iters=iters),
        "walk_xla": time_ms(walk_x, R0, cands, bm.feats0, nv, iters=iters),
    }
    # The int16-accumulating coarse bound against int32.
    P_ub = jax.jit(jax.vmap(lambda R: M._ub_patches(R, T1, Kc)))(R1).reshape(
        B * Hc * Wc, -1)
    for acc in (jnp.int16, jnp.int32):
        f = jax.jit(lambda A, Wc_, acc=acc: jax.lax.dot_general(
            A, Wc_, (((1,), (1,)), ((), ())), preferred_element_type=acc))
        stage_ms[f"bound_dot_{jnp.dtype(acc).name}"] = time_ms(
            f, P_ub, bm.W_cell, iters=3 if acc == jnp.int16 else iters)
    same = np.array_equal(
        np.asarray(jax.lax.dot_general(P_ub, bm.W_cell, (((1,), (1,)), ((), ())),
                                       preferred_element_type=jnp.int16)).astype(np.int32),
        np.asarray(jax.lax.dot_general(P_ub, bm.W_cell, (((1,), (1,)), ((), ())),
                                       preferred_element_type=jnp.int32)))
    ck.check("int16 bound dot == int32", same)

    # End to end, the pooled match with each walk (alternating).
    def e2e(walk_fn):
        def fn(r, d):
            R0_, R1_ = pre(r, d)
            c, n_, _ = pool(R1_, bm.W1, bm.W_cell, bm.W_fine, bm.feats1)
            return walk_fn(R0_, c, bm.feats0, n_)
        return fn

    e2e_t, e2e_x = e2e(walk), e2e(walk_x)
    ts = {"pooled_e2e_triton": [], "pooled_e2e_xla": []}
    for name, fn in (("pooled_e2e_triton", e2e_t), ("pooled_e2e_xla", e2e_x),
                     ("pooled_e2e_xla", e2e_x), ("pooled_e2e_triton", e2e_t)):
        ts[name].append(time_ms(fn, rgbs, depths, iters=3 * iters))
    for name, v in ts.items():
        stage_ms[name] = float(np.mean(v))
    stage_ms["match_batch"] = time_ms(bm.match_batch, rgbs, depths, iters=iters)
    ck.put("stage_ms", stage_ms)
    ck.put("frames_per_s_pooled", B / stage_ms["match_batch"] * 1e3)
    log(f"stage ms per batch of {B} (median of {iters}):")
    for k, v in stage_ms.items():
        log(f"  {k:<18} {v:9.3f}")

    # ---------------------------------------------------------------- walk
    BK = B * TOP_K
    wi = jax.jit(lambda c, n: M.walk_inputs(bm.feats0, c, T1, E0, T0, (H, W),
                                            n_valid=n))(cands, nv)
    slot_live = wi.slot_live
    xs = jax.jit(lambda *a: M.walk_scores_xla(*a, T0, E0))
    xargs = (R0, wi.frame, wi.oris, wi.fy, wi.fx, wi.live, wi.slot_live,
             wi.gy0, wi.gx0)
    xla_scores = xs(*xargs)
    walk_ms = {"xla": time_ms(xs, *xargs, iters=iters)}
    targs = (R0, wi.frame, wi.oris, wi.fy, wi.fx,
             jnp.where(wi.slot_live, wi.count, 0), wi.gy0, wi.gx0)
    ts_ = jax.jit(lambda *a: WT.walk_scores_triton(*a, T=T0, E0=E0,
                                                   interpret=walk_interpret))
    same = np.array_equal(np.asarray(ts_(*targs)), np.asarray(xla_scores))
    ck.check(f"Triton walk == XLA walk, {BK} slots", same)
    walk_ms["triton"] = time_ms(ts_, *targs, iters=iters)
    ck.put("walk_alone_ms", walk_ms)
    log(f"walk alone (B={B}, K={TOP_K}, {int(np.sum(np.asarray(slot_live)))} live "
        f"slots) ms: {walk_ms}")
    kept = stage_ms["pooled_e2e_triton"] < stage_ms["pooled_e2e_xla"]
    ck.put("walk_decision", "triton" if kept else "xla")
    log(f"walk decision: pooled match e2e {stage_ms['pooled_e2e_triton']:.3f} ms "
        f"(Triton) vs {stage_ms['pooled_e2e_xla']:.3f} ms (XLA) -> "
        f"{'keep' if kept else 'drop'} the Triton walk")

    # --------------------------------------------------------------- forms
    # Detector's coarse scoring: gather scan against the one-hot GEMM.
    R1f = R1[0]
    sc_g = jax.jit(lambda R, f: M.coarse_scores(R, f, T1, Kc))
    sc_c = jax.jit(lambda R, Wg: M.coarse_scores_gemm(R, Wg, T1, Kc))
    same = np.array_equal(np.asarray(sc_g(R1f, bm.feats1)),
                          np.asarray(sc_c(R1f, bm.W1)))
    forms = {"detector_gather": time_ms(sc_g, R1f, bm.feats1, iters=iters),
             "detector_onehot_gemm": time_ms(sc_c, R1f, bm.W1, iters=iters)}
    ck.check("Detector coarse: gather == one-hot GEMM", same)
    ck.put("forms_ms", forms)
    log(f"forms ms: {forms}; default detector_engine "
        f"{backend.detector_engine()!r}")

    # -------------------------------------------------------------- served
    cparams = CC.CascadeParams(canonicalize="none", icp_variant="point_to_plane",
                               orientation_hypotheses=2, nms_after_pose=True)
    meta_t = tiled_metadata(meta, args.reps, N)
    K_cam = jnp.asarray([[glob.focal_length_x, 0, W / 2.0],
                         [0, glob.focal_length_y, H / 2.0], [0, 0, 1.0]], jnp.float32)

    def frame_of(i):
        cloud = np.asarray(pcu.depth_to_cloud(
            jnp.asarray(depths_np[i]) / 1000.0, K_cam), np.float32)
        return Frame(rgb=frames[i], cloud=cloud)

    def service(det_):
        state = {"i": 0}
        svc = PoseService(lambda: frame_of(state["i"]))
        svc.register_object(0, ObjectConfig(DetectionPipeline(
            det_, meta_t, glob, box_stl, cparams), threshold=THRESHOLD))
        return svc, state

    svc, state = service(det)
    pipe = svc.objects[0].pipeline
    fr0 = frame_of(0)
    t0 = time.perf_counter()
    depth0 = np.asarray(pcu.cloud_to_depth_mm(jnp.asarray(fr0.cloud)), np.float32)
    m0 = det.match_raw(fr0.rgb, THRESHOLD, depth_mm=depth0, class_ids=[cid],
                       top_k=cparams.max_matches)[cid]
    jax.block_until_ready(m0)
    t_match = time.perf_counter() - t0
    _, t_pose = timed_compile("served pose stage", pipe._pose_stage, m0,
                              jnp.asarray(fr0.cloud))
    ck.put("served_first_call_s", {"match_raw": t_match, "pose_stage_compile": t_pose})
    log(f"served first call: match_raw {t_match:.1f} s (compile + run), "
        f"pose stage compile {t_pose:.1f} s")
    served = []
    for i in range(3):
        state["i"] = i % B
        t0 = time.perf_counter()
        tr = svc.linemod_object_pose(0)
        dt = time.perf_counter() - t0
        dets = svc.detect_camera_frame(0)
        errs = []
        if dets:
            pose = dets[0].pose
            for vid, x, y in truths[i % B]:
                z = float(np.linalg.norm(meta.T[vid]))
                rect = meta.Rect[vid]
                # Approximate truth: the rendered view's pose, moved by the
                # image-plane shift of its plant (not exact under
                # perspective; printed, not gated).
                du = x - rect[0]
                dv = y - rect[1]
                t_true = np.array([du * z / glob.focal_length_x,
                                   dv * z / glob.focal_length_y, z])
                r_err = float(geo.rotation_geodesic_deg(
                    jnp.asarray(pose[:3, :3]), jnp.asarray(meta.R[vid])))
                errs.append((r_err, float(np.linalg.norm(pose[:3, 3] - t_true) * 1e3)))
        best = min(errs) if errs else None
        served.append({"request": i, "seconds": dt, "detections": len(dets),
                       "translation": list(map(float, tr.translation)),
                       "rotation_xyzw": list(map(float, tr.rotation)),
                       "err_deg_mm_vs_planted": best,
                       "icp_iterations": dets[0].icp_iterations if dets else None})
        log(f"request {i}: {len(dets)} detections, {dt * 1e3:.1f} ms, "
            f"error vs planted view (deg, mm) {best}")
    ck.put("served", served)
    ck.check("served path answers 3 requests", len(served) == 3)
    lat = []
    for i in range(12):
        state["i"] = i % B
        t0 = time.perf_counter()
        svc.linemod_object_pose(0)
        lat.append((time.perf_counter() - t0) * 1e3)
    ck.put("served_latency_ms", {"p50": float(np.percentile(lat, 50)),
                                 "max": float(np.max(lat)), "n": len(lat)})
    log(f"served latency over {len(lat)} warm requests: p50 "
        f"{np.percentile(lat, 50):.1f} ms, max {np.max(lat):.1f} ms")

    state["i"] = 0
    dets_g = svc.detect_camera_frame(0)
    with jax.default_device(cpu):
        det_c, _, _, _ = load_bank(args.reps)
        svc_c, state_c = service(det_c)
        state_c["i"] = 0
        dets_c = svc_c.detect_camera_frame(0)
    if dets_g and dets_c:
        pg, pc = dets_g[0].pose, dets_c[0].pose
        d_deg = float(geo.rotation_geodesic_deg(jnp.asarray(pg[:3, :3]),
                                                jnp.asarray(pc[:3, :3])))
        d_mm = float(np.linalg.norm(pg[:3, 3] - pc[:3, 3]) * 1e3)
        its = (dets_g[0].icp_iterations, dets_c[0].icp_iterations)
        ck.put("served_gpu_vs_cpu", {"deg": d_deg, "mm": d_mm, "icp_iterations": its})
        log(f"served pose GPU vs CPU: {d_deg:.5f} deg, {d_mm:.5f} mm; "
            f"ICP iterations GPU {its[0]}, CPU {its[1]}")
        ck.check("served pose GPU vs CPU within 0.05 deg / 0.5 mm",
                 d_deg <= 0.05 and d_mm <= 0.5, f"{d_deg:.5f} deg, {d_mm:.5f} mm")
    else:
        ck.check("served pose GPU vs CPU", False,
                 f"detections: GPU {len(dets_g)}, CPU {len(dets_c)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="scene seed")
    ap.add_argument("--batch", type=int, default=32, help="frames per batch")
    ap.add_argument("--reps", type=int, default=4, help="bank tiling factor")
    ap.add_argument("--iters", type=int, default=10, help="timed calls per stage")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from linemod_pose_estimation.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
        f"jax {jax.__version__}")
    card = card_line()
    log(f"card: {card}")
    ck = Checks()
    ck.put("card", card)
    run(args, ck)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"failed": ck.failed, **ck.record}, f, indent=1, default=str)
    if ck.failed:
        print(f"chip_smoke: {len(ck.failed)} checks failed: {ck.failed}",
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
