"""Refresh ONLY the pose sections of ACCURACY.json (RGB and/or RGB-D).

The full accuracy tools (run_accuracy_eval*.py) re-measure everything —
match sweep, vs_opencv head-to-head, the 120-scene bank A/B — which costs
hours on a host-CPU backend.  Pose-stage changes (ICP variants, the
in-plane rank-deficiency sweep, hypothesis selection) only move the
`pose` / `rgbd.pose` dicts, so this tool re-trains the same ~100-view
bank and re-runs evaluate_pose (n=50) alone, merging the result into an
existing report in place.

Usage: python tools/refresh_pose_accuracy.py [rgb|rgbd|both] [ACCURACY.json]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from linemod_pose_estimation.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import numpy as np

from linemod_pose_estimation import eval as EV
from linemod_pose_estimation.models import cascade as CC
from linemod_pose_estimation.models.detector import Detector
from linemod_pose_estimation.models.pipeline import DetectionPipeline
from linemod_pose_estimation.models.renderer import Renderer
from linemod_pose_estimation.models.templates import (
    DetectorParams, TemplateBank, TemplateMetadata,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "data", "boxNew_rgbd_params.yml.gz")
STL = os.path.join(REPO, "data", "box_fitted.stl")
W, H = 640, 480
N_TRAIN = 100
N_POSE = 50


def _log(m):
    print(f"[pose-refresh] {m}", flush=True)


def pose_section(use_depth: bool) -> dict:
    meta_full, glob = TemplateBank.read_params_yaml(BANK)
    r = Renderer(STL, W, H, glob.focal_length_x, glob.focal_length_y)
    # Re-training the same ~100 views costs ~40 CPU-minutes; LPE_BANK_CACHE
    # names a directory where the trained detector + kept-view metadata are
    # cached per modality (host-CPU iteration on pose-stage changes).
    cache = os.environ.get("LPE_BANK_CACHE")
    tag = "rgbd" if use_depth else "rgb"
    det_p = cache and os.path.join(cache, f"pose_refresh_{tag}.yml")
    meta_p = cache and os.path.join(cache, f"pose_refresh_{tag}.npz")
    if det_p and os.path.exists(det_p) and os.path.exists(meta_p):
        det = Detector.read(det_p)
        z = np.load(meta_p)
        meta = TemplateMetadata(R=z["R"], T=z["T"], K=z["K"], D=z["D"],
                                Ori_dist=z["Ori_dist"], Rect=z["Rect"])
        _log(f"loaded cached {tag} bank from {cache}")
        return _pose_eval(det, meta, glob, use_depth, r)
    ids = list(range(0, meta_full.R.shape[0], 26))[:N_TRAIN]
    det = Detector(DetectorParams(use_depth_normal=use_depth))
    kept = []
    t0 = time.time()
    for i in ids:
        out = r.render(meta_full.R[i], meta_full.T[i])
        tid = det.add_template(
            np.asarray(out.rgb), np.asarray(out.mask), "boxNew",
            depth_mm=(np.asarray(out.depth_mm).astype(np.float32)
                      if use_depth else None),
        )
        if tid >= 0:
            kept.append(i)
    _log(f"trained {len(kept)} templates (use_depth={use_depth}, "
         f"{time.time()-t0:.0f}s)")
    meta = TemplateMetadata(
        R=meta_full.R[kept], T=meta_full.T[kept], K=meta_full.K[kept],
        D=meta_full.D[kept], Ori_dist=meta_full.Ori_dist[kept],
        Rect=meta_full.Rect[kept],
    )
    if det_p:
        det.write(det_p)
        np.savez(meta_p, R=meta.R, T=meta.T, K=meta.K, D=meta.D,
                 Ori_dist=meta.Ori_dist, Rect=meta.Rect)
    return _pose_eval(det, meta, glob, use_depth, r)


def _pose_eval(det, meta, glob, use_depth: bool, r) -> dict:
    params = CC.CascadeParams(
        canonicalize="none", max_clusters=2, cluster_filter_thresh=0,
        icp_variant="point_to_plane", orientation_hypotheses=2,
        nms_after_pose=True,
    )
    pipe = DetectionPipeline(det, meta, glob, STL, params, render_size=(W, H))
    t0 = time.time()
    pcases = EV.evaluate_pose(pipe, r, meta,
                              list(range(meta.R.shape[0]))[:N_POSE],
                              threshold=85.0, use_depth=use_depth)
    _log(f"pose eval n={len(pcases)} ({time.time()-t0:.0f}s)")
    return EV.summarize([], pcases)["pose"]


def main() -> None:
    modality = sys.argv[1] if len(sys.argv) > 1 else "both"
    out_path = sys.argv[2] if len(sys.argv) > 2 else "ACCURACY.json"
    if modality not in ("rgb", "rgbd", "both"):
        raise SystemExit(f"unknown modality {modality!r} (rgb|rgbd|both)")

    with open(out_path) as f:
        report = json.load(f)
    if modality in ("rgb", "both"):
        report["pose"] = pose_section(use_depth=False)
        _log(f"rgb pose: {json.dumps(report['pose'])}")
    if modality in ("rgbd", "both"):
        report.setdefault("rgbd", {})["pose"] = pose_section(use_depth=True)
        _log(f"rgbd pose: {json.dumps(report['rgbd']['pose'])}")
    EV.write_report(out_path, report)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
