"""Extend ACCURACY.json with the dual-modality (RGB-D) section.

The reference's flagship trainer is ColorGradient+DepthNormal
(renderer.cpp:179-185) and the carmine node matches both modalities per
frame (linemod_carmine_detect.cpp:329-333); the round-3 ACCURACY.json only
measured the ColorGradient cascade.  This tool trains a dual-modality
detector on the same ~100 reference-bank views (depth from the renderer),
then reports under the "rgbd" key:

- pose:    full-cascade 6D accuracy (n=50) with depth fed to the matcher,
- vs_opencv: head-to-head vs the GENUINE dual-modality cv::linemod
  (templates bridged through the yml interchange, depth given to both),
- bank_ab: the depth-bearing scene corpus (90 scenes: shifted/cluttered/
  multi/occluded/negatives) at the production threshold, depth to both.

Usage: python tools/run_accuracy_eval_rgbd.py [ACCURACY.json]
Merges into an existing report; numbers are backend-independent.
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
THRESH_AB = 92.0


def _log(m):
    print(f"[accuracy-rgbd] {m}", flush=True)


def main(out_path: str = "ACCURACY.json") -> None:
    t_start = time.time()
    meta_full, glob = TemplateBank.read_params_yaml(BANK)
    r = Renderer(STL, W, H, glob.focal_length_x, glob.focal_length_y)

    ids = list(range(0, meta_full.R.shape[0], 26))[:N_TRAIN]
    det = Detector(DetectorParams(use_depth_normal=True))
    kept = []
    for i in ids:
        out = r.render(meta_full.R[i], meta_full.T[i])
        tid = det.add_template(
            np.asarray(out.rgb), np.asarray(out.mask), "boxNew",
            depth_mm=np.asarray(out.depth_mm).astype(np.float32),
        )
        if tid >= 0:
            kept.append(i)
    _log(f"trained {len(kept)} dual-modality templates at {W}x{H}")
    meta = TemplateMetadata(
        R=meta_full.R[kept], T=meta_full.T[kept], K=meta_full.K[kept],
        D=meta_full.D[kept], Ori_dist=meta_full.Ori_dist[kept],
        Rect=meta_full.Rect[kept],
    )
    params = CC.CascadeParams(
        canonicalize="none", max_clusters=2, cluster_filter_thresh=0,
        icp_variant="point_to_plane", orientation_hypotheses=2,
        nms_after_pose=True,
    )
    pipe = DetectionPipeline(det, meta, glob, STL, params, render_size=(W, H))

    view_ids = list(range(len(kept)))
    sec: dict = {}
    t0 = time.time()
    mcases = EV.evaluate_match_px(det, r, meta, view_ids, threshold=85.0,
                                  use_depth=True)
    _log(f"match eval n={len(mcases)} ({time.time()-t0:.0f}s)")
    t0 = time.time()
    pcases = EV.evaluate_pose(pipe, r, meta, view_ids[:N_POSE], threshold=85.0,
                              use_depth=True)
    _log(f"pose eval n={len(pcases)} ({time.time()-t0:.0f}s)")
    s = EV.summarize(mcases, pcases)
    sec["match"], sec["pose"] = s["match"], s["pose"]

    t0 = time.time()
    sec["vs_opencv"] = EV.evaluate_vs_opencv(det, r, meta, view_ids,
                                             threshold=85.0, use_depth=True)
    _log(f"vs_opencv ({time.time()-t0:.0f}s)")

    t0 = time.time()
    rng = np.random.default_rng(11)
    scenes = EV.make_ab_scenes(r, meta, view_ids, W, H, rng, with_depth=True)
    sec["bank_ab"] = EV.evaluate_bank_ab(det, scenes, threshold=THRESH_AB)
    _log(f"bank A/B over {len(scenes)} depth scenes ({time.time()-t0:.0f}s)")

    sec["config"] = {
        "bank": f"boxNew shipped-bank poses, {len(kept)} views, "
                "ColorGradient+DepthNormal",
        "render": f"{W}x{H} at reference intrinsics; scene depth = rendered "
                  "object over 1500 mm plane, occluders in front",
        "ab_threshold": THRESH_AB,
        "wall_s": round(time.time() - t_start, 1),
    }

    report = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            report = json.load(f)
    report["rgbd"] = sec
    EV.write_report(out_path, report)
    print("wrote", out_path)
    print(json.dumps(sec, indent=2))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "ACCURACY.json")
