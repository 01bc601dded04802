"""Streaming multi-camera batched inference — the last BASELINE.md
benchmark config: N replayed camera streams (fixed sensor cadence, ring-
buffer backlog semantics) -> FrameBatcher.poll_batch -> the production
batched matcher -> cascade (pose of the batch's best detection), run
continuously with two batches in flight (PipelinedRunner), for ~30 s.

The reference analog is the carmine node's continuous callback loop, which
processes ONE frame at a time and drops the backlog
(linemod_carmine_detect.cpp:296-306); here late frames
batch up and ride one fixed-shape device step.

Records into STREAMING.json: sustained fps per device, offered load, per-frame
end-to-end latency (grab -> results on host) p50/p99, batch-fill
distribution, drops, and cascade event count.  Two configs: paced (offered
load ~= measured capacity, the latency-under-load story) and saturated
(cameras faster than the device, the capacity story).

Usage: python tools/bench_streaming.py   (runs on JAX's default device)
Env: LPE_STREAM_SECS (default 30), LPE_STREAM_CAMS (8), LPE_STREAM_BATCH
(32), LPE_STREAM_FPS (per-camera cadence; default picks ~0.9x capacity),
LPE_STREAM_TILE (bank tile target, default 10240 — shrink for CPU smokes).
"""

import json
import os
import sys
import time
from collections import deque
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from linemod_pose_estimation.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import bench as B  # noqa: E402
from linemod_pose_estimation.models.detector import Detector  # noqa: E402
from linemod_pose_estimation.models.renderer import Renderer  # noqa: E402
from linemod_pose_estimation.models.templates import TemplateBank  # noqa: E402
from linemod_pose_estimation.models.serving import PipelinedRunner  # noqa: E402
from linemod_pose_estimation.ops import match as M  # noqa: E402
from linemod_pose_estimation.parallel.ingest import (  # noqa: E402
    FrameBatcher, PacedSource,
)
from linemod_pose_estimation.utils import pointcloud as pcu  # noqa: E402
from linemod_pose_estimation.utils.scenes import bin_picking_scenes  # noqa: E402


def build_step(Bsz):
    """One fused device step: preprocess -> pooled exact pruning -> walk ->
    pose cascade on the batch's best-scoring frame.  Returns (step fn,
    scene frames/depths to replay, weights tuple)."""
    tpl, prm = B._bank_paths()
    det = Detector.read(tpl)
    meta, glob = TemplateBank.read_params_yaml(prm)
    bank = det.bank(det.class_ids[0])
    p = det.params
    T0, T1 = p.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    E0 = bank.extent(0)
    use_depth = p.use_depth_normal
    C = 16 if use_depth else 8
    thr, top_k = 91.0, 128
    fine_g = 4
    pool1 = int(os.environ.get("LPE_STREAM_POOL1", str(64 * Bsz)))
    pool2 = int(os.environ.get("LPE_STREAM_POOL2", str(40 * Bsz)))

    n0 = bank.num_templates
    tile_to = int(os.environ.get("LPE_STREAM_TILE", "10240"))
    reps = max(1, -(-tile_to // n0))
    N = ((n0 * reps + 127) // 128) * 128
    feats1 = M.tile_level_features(bank.merged_features(1), reps, N)
    feats0 = M.tile_level_features(bank.merged_features(0), reps, N)
    W_gemm = M.build_gemm_weights(feats1, C, T1, Kc1)
    W_cell = M.build_cell_weights(feats1, C, T1, Kc1)
    W_fine = M.build_cell_weights_fine(feats1, C, T1, Kc1, fine_g)
    jax.block_until_ready((W_gemm, W_cell, W_fine))

    rng = np.random.default_rng(11)
    r = Renderer(B.BOX_STL, glob.width, glob.height, glob.focal_length_x,
                 glob.focal_length_y)
    frames, depths_np, _ = bin_picking_scenes(r, meta, 16, glob.height,
                                              glob.width, rng)

    Hc, Wc = glob.height // 2 // T1, glob.width // 2 // T1
    vpos = M.position_validity_flat(feats1.size, T1, Hc, Wc)
    pose_stage = B.make_real_pose_stage(meta, glob, reps)
    K_render = jnp.array(
        [[glob.focal_length_x, 0, glob.width / 2.0],
         [0, glob.focal_length_y, glob.height / 2.0], [0, 0, 1.0]],
        jnp.float32)

    @jax.jit
    def step(rgbs, depths, Wg, Wcell, Wf):
        R0, R1 = M.preprocess_frames_batched(
            rgbs, depths, T0=T0, T1=T1, use_depth=use_depth,
            weak_threshold=p.color.weak_threshold)
        cand, n_valid, stats = M.match_pooled_fine_with_fallback(
            R1, Wg, Wcell, Wf, feats1.count, vpos, thr - 5.0, T1, Kc1,
            fine_g, pool1, pool2, top_k, Wc)
        m = M.refine_candidates_opencv_batched(
            R0, feats0, cand, T1, thr, E0=E0, fine_T=T0, n_valid=n_valid)
        # Cascade event: full pose stage on the batch's best-scoring frame.
        best = jnp.max(jnp.where(m.valid, m.similarity, -1.0), axis=1)
        b = jnp.argmax(best)
        m1 = M.Matches(*(a[b] for a in m))
        cloud = pcu.depth_to_cloud(depths[b] / 1000.0, K_render)
        poses, pvalid = pose_stage(m1, cloud)
        return m.valid, poses, pvalid, stats.fallback

    return step, frames, depths_np, (W_gemm, W_cell, W_fine)


def run_stream(step, weights, frames, depths_np, Bsz, n_cams, cam_fps, secs):
    H, W = frames.shape[1:3]
    n_scenes = frames.shape[0]

    def make_cam(cid):
        state = {"i": cid}

        def grab():
            i = state["i"] % n_scenes
            state["i"] += 1
            return SimpleNamespace(rgb=frames[i], cloud=depths_np[i])

        return grab

    t_start = time.perf_counter()
    cams = [PacedSource(make_cam(c), cam_fps,
                        start=t_start + c / (cam_fps * n_cams))
            for c in range(n_cams)]
    batcher = FrameBatcher(cams, Bsz)
    run = PipelinedRunner(lambda r, d: step(r, d, *weights), depth=2)
    meta_q = deque()
    lats, fills, events, fallbacks = [], [], 0, 0
    done = 0
    t_end = t_start + secs

    def harvest(out):
        nonlocal done, events, fallbacks
        stamps, n = meta_q.popleft()
        t_done = time.perf_counter()
        lats.extend(((t_done - stamps[:n]) * 1e3).tolist())
        fills.append(n)
        valid, poses, pvalid, fb = out
        events += 1
        fallbacks += int(np.asarray(fb))
        done += n

    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        got = batcher.poll_batch(now)
        if got is None:
            time.sleep(0.0005)
            continue
        rgbs, deps, stamps, n = got
        out = run.submit(jnp.asarray(rgbs), jnp.asarray(deps))
        meta_q.append((stamps, n))
        if out is not None:
            harvest(out)
    for out in run.drain():
        harvest(out)
    wall = time.perf_counter() - t_start
    dropped = sum(c.dropped for c in cams)
    lats = np.asarray(lats)
    fills = np.asarray(fills)
    return {
        "cameras": n_cams,
        "camera_fps": round(cam_fps, 1),
        "offered_fps": round(n_cams * cam_fps, 1),
        "batch": Bsz,
        "duration_s": round(wall, 2),
        "frames_processed": int(done),
        "sustained_fps": round(done / wall, 1),
        "latency_p50_ms": round(float(np.percentile(lats, 50)), 2),
        "latency_p90_ms": round(float(np.percentile(lats, 90)), 2),
        "latency_p99_ms": round(float(np.percentile(lats, 99)), 2),
        "batch_fill_mean": round(float(fills.mean()), 1),
        "batch_fill_p10": int(np.percentile(fills, 10)),
        "batch_fill_p90": int(np.percentile(fills, 90)),
        "steps": int(fills.size),
        "dropped_frames": int(dropped),
        "cascade_events": int(events),
        "fallback_batches": int(fallbacks),
    }


def main():
    Bsz = int(os.environ.get("LPE_STREAM_BATCH", "32"))
    n_cams = int(os.environ.get("LPE_STREAM_CAMS", "8"))
    secs = float(os.environ.get("LPE_STREAM_SECS", "30"))

    step, frames, depths_np, weights = build_step(Bsz)

    # Warm up / compile, then measure raw step capacity.
    r0 = jnp.asarray(np.stack([frames[i % frames.shape[0]] for i in range(Bsz)]))
    d0 = jnp.asarray(np.stack([depths_np[i % frames.shape[0]] for i in range(Bsz)]))
    t0 = time.perf_counter()
    jax.block_until_ready(step(r0, d0, *weights))
    print(f"[stream] compile {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    iters = 10
    for _ in range(iters):
        out = step(r0, d0, *weights)
    jax.block_until_ready(out)
    cap_fps = Bsz * iters / (time.perf_counter() - t0)
    print(f"[stream] step capacity ~{cap_fps:.0f} fps", file=sys.stderr)

    cam_fps = float(os.environ.get("LPE_STREAM_FPS",
                                   str(0.9 * cap_fps / n_cams)))
    paced = run_stream(step, weights, frames, depths_np, Bsz, n_cams,
                       cam_fps, secs)
    print(f"[stream] paced: {paced}", file=sys.stderr)
    sat = run_stream(step, weights, frames, depths_np, Bsz, n_cams,
                     cap_fps * 2.0 / n_cams, secs)
    print(f"[stream] saturated: {sat}", file=sys.stderr)

    out = {
        "config": ("N paced replay cameras -> FrameBatcher.poll_batch -> "
                   "pooled batched matcher + walk -> pose cascade on the "
                   "batch's best frame, 2 batches in flight "
                   "(PipelinedRunner)"),
        "device": jax.devices()[0].device_kind,
        "step_capacity_fps": round(cap_fps, 1),
        "paced": paced,
        "saturated": sat,
    }
    with open(os.path.join(REPO, "STREAMING.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
