"""Train a boxNew-scale template bank from an STL mesh and write it.

    python tools/train_bank.py [--depth] [--max-views N] [--stl PATH]
                               [--out-dir DIR]

The reference's renderer_node configuration (renderer.cpp:179-185): a
150-point view sphere, 10-degree in-plane steps, radius 0.5-1.0 m in 0.1
steps, 640x480, T = {5, 8}; ColorGradient, plus DepthNormal with --depth.
At full scale that is 2652 views, the size of the committed banks.
Writes <stem>_templates.yml and <stem>_params.yml to --out-dir (default
chiprun_out/) and prints one JSON line with the wall time and views/s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from linemod_pose_estimation.utils.compile_cache import configure_compile_cache  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth", action="store_true",
                    help="train ColorGradient + DepthNormal")
    ap.add_argument("--max-views", type=int, default=2652)
    ap.add_argument("--stl", default=os.path.join(REPO, "data", "box_fitted.stl"))
    ap.add_argument("--out-dir", default=os.path.join(REPO, "chiprun_out"))
    a = ap.parse_args()

    configure_compile_cache()
    import jax

    from linemod_pose_estimation.models.templates import DetectorParams
    from linemod_pose_estimation.models.trainer import TrainerConfig, train_and_write
    from linemod_pose_estimation.utils.viewsphere import ViewSphereParams

    cfg = TrainerConfig(
        view_sphere=ViewSphereParams(
            n_points=150, angle_step=10, radius_min=0.5, radius_max=1.0,
            radius_step=0.1,
        ),
        detector=DetectorParams(use_depth_normal=a.depth),
    )
    stem = "box_rgbd" if a.depth else "box_full"
    os.makedirs(a.out_dir, exist_ok=True)
    tpl = os.path.join(a.out_dir, f"{stem}_templates.yml")
    prm = os.path.join(a.out_dir, f"{stem}_params.yml")
    t0 = time.perf_counter()
    _, bank = train_and_write(a.stl, tpl, prm, cfg, max_views=a.max_views)
    dt = time.perf_counter() - t0
    dev = jax.devices()[0]
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "stl": os.path.relpath(a.stl, REPO),
        "modalities": "ColorGradient+DepthNormal" if a.depth else "ColorGradient",
        "requested_views": a.max_views,
        "templates": bank.num_templates,
        "wall_s": dt,
        "views_per_s": a.max_views / dt,
        "bank_files": [tpl, prm],
    }))


if __name__ == "__main__":
    main()
