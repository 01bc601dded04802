"""Executable entry points: ``python -m linemod_pose_estimation <cmd>``.

The reference ships four CLIs (SURVEY.md section 5 "Config / flag system"):
the two trainers (renderer.cpp:203-237, renderer_only_image.cpp argv) and
the detector/service nodes with 11-15 positional args whose canonical
values live in the launch files (start_object_detection.launch:5-19:
threshold 92/94, icp 150 / 1e-5 / 0.02 / 0.05, clustering_step 20,
orientation_clustering 10, nms 4) and the ``params`` example lines.  This
module mirrors those contracts as named flags with the same defaults:

  train    STL -> templates.yml + renderer_params.yml   (renderer_node)
  detect   banks + replay frames -> detections JSON     (detector node)
  serve    object registry + frame source -> pose RPC   (service node;
           object_id requests on stdin, base-frame Transform JSON out,
           identity on miss — service.cpp:1832-1846)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_trainer_args(p: argparse.ArgumentParser) -> None:
    # renderer.cpp:203-237 defaults; launch/start_object_renderer.launch:5-18.
    p.add_argument("stl", help="CAD mesh (.stl, ASCII or binary)")
    p.add_argument("--templates-out", required=True, help="templates.yml path")
    p.add_argument("--params-out", required=True, help="renderer_params.yml path")
    p.add_argument("--class-id", default="obj")
    p.add_argument("--n-points", type=int, default=150)
    p.add_argument("--angle-step", type=int, default=10)
    p.add_argument("--radius-min", type=float, default=0.5)
    p.add_argument("--radius-max", type=float, default=1.0)
    p.add_argument("--radius-step", type=float, default=0.1)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--fx", type=float, default=535.566011)
    p.add_argument("--fy", type=float, default=537.168115)
    p.add_argument("--near", type=float, default=0.1)
    p.add_argument("--far", type=float, default=1000.0)
    p.add_argument(
        "--rgb-depth", action="store_true",
        help="train ColorGradient + DepthNormal (renderer_node); default is "
             "RGB-only (renderer_only_image_node, used for the Ensenso banks)",
    )
    p.add_argument("--max-views", type=int, default=None,
                   help="cap the view count (smoke runs)")


def _cascade_args(p: argparse.ArgumentParser) -> None:
    # start_object_detection.launch:5-19 / service.cpp:1922-1941 argv layer.
    p.add_argument("--threshold", type=float, default=92.0)
    p.add_argument("--icp-max-iter", type=int, default=150)
    p.add_argument("--icp-tr-epsilon", type=float, default=1e-5)
    p.add_argument("--icp-ransac-thresh", type=float, default=0.02)
    p.add_argument("--icp-max-corr-dist", type=float, default=0.05)
    p.add_argument("--clustering-step", type=int, default=20)
    p.add_argument("--orientation-clustering-th", type=float, default=10.0)
    p.add_argument("--cluster-filter-thresh", type=int, default=2)
    p.add_argument("--bias-x", type=int, default=0,
                   help="Ensenso 752->640 crop offset (service.cpp:212)")
    p.add_argument("--canonicalize", choices=["x_front", "z_down", "none"],
                   default="x_front")
    p.add_argument("--icp-variant",
                   choices=["two_stage", "nonlinear", "point_to_plane"],
                   default="two_stage",
                   help="icpPoseRefine vs icpNonLinearPoseRefine (LM) vs the "
                        "point-to-plane accuracy variant")
    p.add_argument("--accuracy", action="store_true",
                   help="the measured-best pose config: point-to-plane ICP, "
                        "two orientation hypotheses per cluster and "
                        "pose-aware NMS (ACCURACY.json: deg max 0.92 over "
                        "n=50 at 640x480)")
    # Static device capacities (CascadeParams); smaller values compile and
    # run faster on small scenes.
    p.add_argument("--max-clusters", type=int, default=4)
    p.add_argument("--model-cap", type=int, default=1024)
    p.add_argument("--scene-cap", type=int, default=1024)


def _cascade_from_args(a) -> "CascadeParams":
    from .models.cascade import CascadeParams

    acc = getattr(a, "accuracy", False)
    return CascadeParams(
        clustering_step=a.clustering_step,
        cluster_filter_thresh=a.cluster_filter_thresh,
        orientation_clustering_th=a.orientation_clustering_th,
        icp_max_iter=a.icp_max_iter,
        icp_max_corr_dist=a.icp_max_corr_dist,
        icp_tr_epsilon=a.icp_tr_epsilon,
        icp_ransac_thresh=a.icp_ransac_thresh,
        bias_x=a.bias_x,
        canonicalize=a.canonicalize,
        icp_variant="point_to_plane" if acc else a.icp_variant,
        orientation_hypotheses=2 if acc else 1,
        nms_after_pose=acc,
        max_clusters=a.max_clusters,
        model_cap=a.model_cap,
        scene_cap=a.scene_cap,
    )


def cmd_train(a) -> int:
    from .models.templates import DetectorParams
    from .models.trainer import TrainerConfig, train_from_stl
    from .utils.viewsphere import ViewSphereParams

    cfg = TrainerConfig(
        view_sphere=ViewSphereParams(
            n_points=a.n_points, angle_step=a.angle_step,
            radius_min=a.radius_min, radius_max=a.radius_max,
            radius_step=a.radius_step,
        ),
        width=a.width, height=a.height,
        focal_length_x=a.fx, focal_length_y=a.fy,
        near=a.near, far=a.far,
        detector=DetectorParams(use_depth_normal=a.rgb_depth),
        class_id=a.class_id,
    )
    det, bank = train_from_stl(a.stl, cfg, max_views=a.max_views, progress=True)
    bank.write_templates_yaml(a.templates_out)
    bank.write_params_yaml(a.params_out)
    print(json.dumps({
        "templates": bank.num_templates,
        "templates_yml": a.templates_out,
        "params_yml": a.params_out,
    }))
    return 0


def _pipeline_from_args(a, templates_yml, params_yml, stl):
    from .models.pipeline import DetectionPipeline

    return DetectionPipeline.from_files(
        templates_yml, params_yml, stl, _cascade_from_args(a)
    )


def cmd_detect(a) -> int:
    from .api.nodes import ReplayFrameSource

    pipe = _pipeline_from_args(a, a.templates, a.params, a.stl)
    src = ReplayFrameSource(a.frames)
    for i in range(a.count if a.count > 0 else len(src.frames)):
        f = src()
        dets = pipe.detect(f.rgb, f.cloud, a.threshold)
        print(json.dumps({
            "frame": i,
            "detections": [
                {
                    "pose": np.asarray(d.pose).tolist(),
                    "rect": list(d.rect),
                    "score": d.score,
                    "icp_fitness": d.icp_fitness,
                    "hv_rate": d.hv_rate,
                }
                for d in dets
            ],
        }))
    return 0


def cmd_serve(a) -> int:
    from .api.nodes import ReplayFrameSource
    from .api.service import ObjectConfig, PoseService

    src = ReplayFrameSource(a.frames)
    svc = PoseService(src, bias_x=a.bias_x)
    # --object id:templates.yml:params.yml:mesh.stl[:threshold], repeatable —
    # the two-object registry of the reference service (0 = memory chip,
    # 1 = CPU; service.cpp:1784/1851).
    for spec in a.object:
        parts = spec.split(":")
        if len(parts) not in (4, 5):
            print(f"bad --object spec: {spec}", file=sys.stderr)
            return 2
        oid = int(parts[0])
        thr = float(parts[4]) if len(parts) == 5 else a.threshold
        pipe = _pipeline_from_args(a, parts[1], parts[2], parts[3])
        svc.register_object(oid, ObjectConfig(pipeline=pipe, threshold=thr))
    print(json.dumps({"serving": sorted(svc.objects)}), flush=True)
    # Request loop: one object_id per line (the /linemod_object_pose RPC),
    # response = base-frame Transform JSON; identity on miss.
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line in ("q", "quit", "exit"):
            break
        try:
            # Accept a bare int or {"object_id": N} (the srv request shape).
            req = json.loads(line)
            object_id = int(req["object_id"]) if isinstance(req, dict) else int(req)
        except (ValueError, TypeError, KeyError):
            print(json.dumps({"error": f"bad request {line!r}"}), flush=True)
            continue
        t = svc.linemod_object_pose(object_id)
        print(json.dumps({
            "object_id": object_id,
            "translation": [float(v) for v in t.translation],
            "rotation_xyzw": [float(v) for v in t.rotation],
        }), flush=True)
    return 0


def main(argv=None) -> int:
    # Persistent compile cache: repeated CLI invocations (detect then serve
    # on the same bank/shapes) reuse each other's XLA programs.
    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    ap = argparse.ArgumentParser(
        prog="linemod_pose_estimation",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="render view sphere -> template bank")
    _add_trainer_args(pt)
    pt.set_defaults(fn=cmd_train)

    pd = sub.add_parser("detect", help="detect objects in replay frames")
    pd.add_argument("templates", help="templates.yml")
    pd.add_argument("params", help="renderer_params.yml")
    pd.add_argument("stl", help="CAD mesh")
    pd.add_argument("frames", help="replay .npz file or directory")
    pd.add_argument("--count", type=int, default=0, help="frames to process (0 = all)")
    _cascade_args(pd)
    pd.set_defaults(fn=cmd_detect)

    ps = sub.add_parser("serve", help="pose service over stdin/stdout")
    ps.add_argument("frames", help="replay .npz file or directory (camera seam)")
    ps.add_argument(
        "--object", action="append", default=[],
        metavar="ID:TEMPLATES:PARAMS:STL[:THRESHOLD]",
        help="register an object (repeatable)",
    )
    _cascade_args(ps)
    ps.set_defaults(fn=cmd_serve)

    a = ap.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    sys.exit(main())
