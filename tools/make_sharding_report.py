"""Reference-scale virtual-mesh sharding artifact (SHARDING.json).

Runs the PRODUCTION sharded detect step (parallel.sharded_match.
make_sharded_detect_step, prune="positions") on the committed real
trained bank tiled to 10k+ templates, over a data=2 x bank=4 mesh of 8
virtual host devices, and records the scale-out math: per-shard template counts, per-shard array bytes (the GEMM
weight shard is the big one), per-shard survivor-GEMM shapes, and the
collective payload (all-gather of O(top_k) match records + scalar
psums) — the wire traffic is independent of bank size.

Usage (from the repo root):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/make_sharding_report.py
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # the report runs on virtual CPU devices
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# On a low-core host the 8 virtual devices timeshare: later shards'
# reference-scale GEMMs arrive at the all-gather rendezvous long after the
# first, and XLA's default 40 s termination timeout aborts the process.
if "collective_call_terminate_timeout" not in flags:
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=300"
              " --xla_cpu_collective_call_terminate_timeout_seconds=1200")
os.environ["XLA_FLAGS"] = flags.strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from linemod_pose_estimation.models.detector import Detector  # noqa: E402
from linemod_pose_estimation.models.templates import TemplateBank  # noqa: E402
from linemod_pose_estimation.ops import match as M  # noqa: E402
from linemod_pose_estimation.parallel.sharded_match import (  # noqa: E402
    make_ring_bank, make_ring_detect_step, make_row_sharded_matcher,
    make_sharded_bank, make_sharded_detect_step,
)


def main():
    import bench as BM

    tpl, prm = BM._bank_paths()
    det = Detector.read(tpl)
    bank = det.bank(det.class_ids[0])
    p = det.params
    T0, T1 = p.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    E0 = bank.extent(0)
    use_depth = p.use_depth_normal
    C = 16 if use_depth else 8
    n0 = bank.num_templates
    reps = max(1, -(-10240 // n0))
    N = ((n0 * reps + 127) // 128) * 128
    feats1 = M.tile_level_features(bank.merged_features(1), reps, N)
    feats0 = M.tile_level_features(bank.merged_features(0), reps, N)

    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "bank"))
    sb = make_sharded_bank(mesh, feats1, feats0, C=C, T1=T1, Kc1=Kc1)

    B, H, W = 2, 480, 640
    top_k, thr, m_cap = 128, 91.0, 64  # fine_pos_cap defaults to m_cap // 2
    step = make_sharded_detect_step(
        mesh, T1, Kc1, top_k, thr, T0=T0, E0=E0, use_depth=use_depth,
        weak_threshold=p.color.weak_threshold, prune=True,
        prune_pos_cap=m_cap, prune_mode="positions",
    )
    # Real bin-picking scenes (rendered views planted on clutter), not
    # noise: the step_output then proves the sharded step FINDS the
    # object at reference scale, not merely that it executes.
    from linemod_pose_estimation.models.renderer import Renderer
    from linemod_pose_estimation.utils.scenes import bin_picking_scenes
    meta, glob = TemplateBank.read_params_yaml(prm)
    r = Renderer(BM.BOX_STL, glob.width, glob.height, glob.focal_length_x,
                 glob.focal_length_y)
    rng = np.random.default_rng(0)
    frames, depths_np, _ = bin_picking_scenes(r, meta, B, H, W, rng)
    rgbs = jnp.asarray(frames)
    depths = jnp.asarray(depths_np)
    matches, metrics = step(rgbs, depths, sb)
    jax.block_until_ready(matches)

    n_bank = mesh.shape["bank"]
    n_data = mesh.shape["data"]
    N_pad = sb.feats1.oris.shape[0]
    n_local = N_pad // n_bank
    Hc, Wc = H // 2 // T1, W // 2 // T1
    K_dim = C * T1 * T1 * Kc1 * Kc1
    KS = Kc1 * T1 // 4  # fine-stage (g=4) subcell grid
    shard_bytes = {
        "W1_rows_int8": int(n_local * K_dim),
        "W_cell_int8": int(n_local * (Kc1 * Kc1 * C)),
        "W_fine_int8": int(n_local * (KS * KS * C)),
        "feats1_feats0": int(sum(
            np.asarray(a).nbytes for a in sb.feats1) // n_bank
            + sum(np.asarray(a).nbytes for a in sb.feats0) // n_bank),
    }
    # Wire bytes per step: all-gather of per-shard refined Matches over the
    # bank axis (every shard sends its (B_local, top_k) records), then
    # scalar psums.  Independent of N.
    B_local = B // n_data
    rec_bytes = 4 * 4 + 1  # t, x, y int32 + sim f32 + valid bool
    allgather_bytes = B_local * top_k * rec_bytes * (n_bank - 1)
    report = {
        "bank_file": os.path.basename(tpl),
        "modalities": "RGB-D" if use_depth else "RGB",
        "templates_total": int(N_pad),
        "mesh": {"data": n_data, "bank": n_bank},
        "templates_per_shard": int(n_local),
        "per_shard_bytes": shard_bytes,
        "per_shard_survivor_gemm": {
            "patches": [B_local, m_cap // 2, K_dim],
            "weights": [K_dim, n_local],
            "out": [B_local, m_cap // 2, n_local],
            "int8_macs": int(B_local * (m_cap // 2) * K_dim * n_local),
            "note": "fine stage (default fine_pos_cap = m_cap // 2) "
                    "compacts positions before the exact GEMM; the "
                    "coarse-fallback branch runs it at m_cap rows",
        },
        "per_shard_fine_ub_gemm": {
            "patches": [B_local * m_cap, KS * KS * C],
            "weights": [n_local, KS * KS * C],
            "int8_macs": int(B_local * m_cap * KS * KS * C * n_local),
        },
        "per_shard_prune_bound_gemm": {
            "patches": [B_local * Hc * Wc, Kc1 * Kc1 * C],
            "weights": [n_local, Kc1 * Kc1 * C],
            "int8_macs": int(B_local * Hc * Wc * Kc1 * Kc1 * C * n_local),
        },
        "ici_bytes_per_step": {
            "matches_all_gather_per_device": int(allgather_bytes),
            "metrics_psum": 8,
            "note": "O(top_k) records/frame; independent of bank size N",
        },
        "step_output": {
            "num_matches": int(np.asarray(metrics["num_matches"])),
            "best_similarity": float(np.asarray(metrics["best_similarity"])),
            "shape": list(np.asarray(matches.similarity).shape),
        },
    }
    print("[shard] static bank-TP section done", file=sys.stderr)

    # ------------------------------------------------------------------
    # RING rotation (make_ring_detect_step): frames stay data-parallel,
    # the bank shard ppermutes around the ring each step — weight bytes
    # in flight replace the static TP layout's frame replication.
    # ------------------------------------------------------------------
    # Ring size 2 by default: each rotation step scores the frame batch
    # EXHAUSTIVELY against one bank shard, and on the timeshared virtual
    # CPU mesh every reference-scale step costs ~10 s of GEMM per device —
    # the wire/overlap math below scales to any ring size analytically.
    n_ring = int(os.environ.get("LPE_SHARD_RING", "2"))
    ring_devices = np.array(jax.devices()[:n_ring])
    ring_mesh = Mesh(ring_devices, ("ring",))
    rb = make_ring_bank(ring_mesh, "ring", feats1, feats0, C=C, T1=T1, Kc1=Kc1)
    ring_step = make_ring_detect_step(
        ring_mesh, "ring", T1, Kc1, top_k, thr, T0=T0, E0=E0,
        use_depth=use_depth, weak_threshold=p.color.weak_threshold,
    )
    print("[shard] ring: compiling + executing...", file=sys.stderr)
    frames_r, depths_r, _ = bin_picking_scenes(r, meta, n_ring, H, W, rng)
    lowered = ring_step.lower(jnp.asarray(frames_r), jnp.asarray(depths_r), rb)
    hlo = lowered.compile().as_text()
    n_cp = hlo.count(" collective-permute(")
    n_cp_async = hlo.count("collective-permute-start(")
    ring_m = ring_step(jnp.asarray(frames_r), jnp.asarray(depths_r), rb)
    jax.block_until_ready(ring_m)
    n_local_r = rb.feats1.oris.shape[0] // n_ring
    w_shard_bytes = K_dim * n_local_r  # int8 (K, N/n) W1 shard
    feats_bytes = (sum(np.asarray(a).nbytes for a in rb.feats1)
                   + sum(np.asarray(a).nbytes for a in rb.feats0)) // n_ring
    report["ring_rotation"] = {
        "mesh": {"ring": n_ring},
        "templates_per_shard": int(n_local_r),
        "rotation_steps": n_ring,
        "weights_in_flight_bytes_per_hop": int(w_shard_bytes + feats_bytes),
        "w1_shard_bytes": int(w_shard_bytes),
        "feats_shard_bytes": int(feats_bytes),
        "total_wire_bytes_per_batch": int(
            (w_shard_bytes + feats_bytes) * (n_ring - 1)),
        "frames_replicated_bytes": 0,
        "static_tp_equivalent_frame_broadcast_bytes": int(
            frames_r.nbytes + depths_r.nbytes) * (n_ring - 1),
        "overlap": {
            "collective_permutes_in_hlo": int(n_cp + n_cp_async),
            "async_start_done_pairs": int(n_cp_async),
            "note": "the ppermute of shard t+1 is issued BEFORE step t's "
                    "GEMM (sharded_match.py make_ring_detect_step), so "
                    "XLA's async collective-permute streams the next "
                    "shard across devices while the current GEMM runs; on the "
                    "CPU virtual mesh the lowering may fuse to sync "
                    "collective-permute ops — the async pair count above "
                    "records what this backend emitted",
        },
        "step_output": {
            "valid_matches": int(np.asarray(ring_m.valid).sum()),
            "best_similarity": float(
                np.asarray(jnp.where(ring_m.valid, ring_m.similarity,
                                     -1.0)).max()),
            "shape": list(np.asarray(ring_m.similarity).shape),
        },
    }
    print("[shard] ring section done", file=sys.stderr)

    # ------------------------------------------------------------------
    # Row-SP (make_row_sharded_matcher): the frame's rows shard over the
    # mesh (context-parallel analog); each device pulls its halo rows
    # from its neighbours with ppermute before scoring its stripe.
    # ------------------------------------------------------------------
    n_rows = 6  # 480 rows / 6 = 80-row level-0 stripes = lcm(2*T1, T0)
    row_mesh = Mesh(np.array(jax.devices()[:n_rows]), ("rows",))
    row_fn = make_row_sharded_matcher(
        row_mesh, "rows", T1, Kc1, top_k, thr, T0=T0, E0=E0,
    )
    pyr = M.preprocess_frames_batched(
        jnp.asarray(frames_r[:1]), jnp.asarray(depths_r[:1]),
        T0=T0, T1=T1, use_depth=use_depth,
        weak_threshold=p.color.weak_threshold)
    R0_1, R1_1 = pyr[0][0], pyr[1][0]
    # Rebuild the (K, N) weights UNCOMMITTED (host round-trip): sb.W1_rows
    # is committed to the 8-device TP mesh, and the 6-device row mesh
    # rejects operands committed elsewhere.
    W1_kn = jax.device_put(np.ascontiguousarray(np.asarray(sb.W1_rows).T))
    row_m = row_fn(R1_1, R0_1, W1_kn, feats1, feats0)
    jax.block_until_ready(row_m)
    H1, W1c = int(R1_1.shape[1]), int(R1_1.shape[2])
    H0 = int(R0_1.shape[1])
    halo1 = T1 * Kc1
    UP = -(-(8 * T0 + E0) // T0) * T0
    halo0 = -(-(16 * T0 + E0) // T0) * T0
    report["row_sp"] = {
        "mesh": {"rows": n_rows},
        "frame": [H, W],
        "stripe_shapes": {
            "level1_per_shard": [C, H1 // n_rows, W1c],
            "level0_per_shard": [C, H0 // n_rows, int(R0_1.shape[2])],
            "anchor_cells_per_shard": [H1 // n_rows // T1, W1c // T1],
        },
        "halo_rows": {"level1_down": halo1, "level0_up": UP,
                      "level0_down": halo0},
        "halo_bytes_per_device": int(
            C * halo1 * W1c + C * (UP + halo0) * R0_1.shape[2]),
        "stripe_bytes_per_device": int(
            C * (H1 // n_rows) * W1c + C * (H0 // n_rows) * R0_1.shape[2]),
        "per_shard_coarse_gemm": {
            "patches": [(H1 // n_rows // T1) * (W1c // T1), K_dim],
            "weights": [K_dim, int(N_pad)],
            "note": "full replicated bank per shard; positions shard 1/n "
                    "— the right axis when the frame, not the bank, is "
                    "the big operand",
        },
        "step_output": {
            "valid_matches": int(np.asarray(row_m.valid).sum()),
            "best_similarity": float(
                np.asarray(jnp.where(row_m.valid, row_m.similarity,
                                     -1.0)).max()),
        },
    }
    print("[shard] row-SP section done", file=sys.stderr)

    out = os.path.join(REPO, "SHARDING.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
