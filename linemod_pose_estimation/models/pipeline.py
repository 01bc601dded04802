"""DetectionPipeline: the full per-frame flow of the reference's detect_cb
(SURVEY.md section 3.2) behind one object.

    pipeline = DetectionPipeline(detector, bank, stl_path, cascade_params)
    detections = pipeline.detect(rgb, cloud)   # -> [Detection(pose, ...)]

Stage order: LINEMOD match (C1) -> rcd voting (C2) -> cluster filter (C3) ->
scoring (C4) -> IoU NMS (C7) -> rough pose by orientation clustering + re-
render (C8/C9) -> two-stage ICP (C10) -> hypothesis verification (C11) ->
canonicalization (C22).  Everything after the match runs as one jitted,
vmapped-over-clusters device program.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import match as M
from ..utils import geometry as geo
from . import cascade as CC
from .detector import Detector
from .renderer import _pad_triangles
from .templates import TemplateBank, TemplateMetadata, RendererGlobals


@dataclass
class Detection:
    """One verified object hypothesis (the reference's ClusterData,
    rgbdDetector.h:68-110)."""

    pose: np.ndarray  # (4, 4) object -> camera
    rect: tuple[int, int, int, int]
    score: float
    icp_fitness: float
    hv_rate: float
    rough_pose: np.ndarray | None = None  # pre-ICP pose (C8/C9)
    icp_iterations: int = 0


@dataclass
class StageOutputs:
    """Per-stage intermediates of one detect() call — the device-side analog
    of the reference's stage-by-stage imshow/PCL-viewer culture (C23:
    service.cpp:362-466, rgbdDetector.cpp:1299-1312).  All arrays are
    fixed-capacity device outputs pulled to host; mask by the valid fields.
    """

    matches: M.Matches  # raw LINEMOD matches (post-refinement)
    clusters: "CC.ClusterSet"  # RCD vote cells after grouping + filtering
    nms_keep: np.ndarray  # (C,) bool — IoU-NMS survivors among clusters
    cluster_order: np.ndarray  # (max_clusters,) cluster indices by score
    poses: "CC.ClusterPose"  # per-cluster rough + refined poses, HV rates


class DetectionPipeline:
    def __init__(
        self,
        detector: Detector,
        metadata: TemplateMetadata,
        globals_: RendererGlobals,
        mesh_or_path,
        params: CC.CascadeParams | None = None,
        class_id: str | None = None,
        render_size: tuple[int, int] | None = None,
    ):
        from ..utils.stl import Mesh, load_stl

        self.detector = detector
        self.class_id = class_id or detector.class_ids[0]
        self.params = params or CC.CascadeParams()
        self.metadata = metadata
        self.globals = globals_

        mesh = load_stl(mesh_or_path) if isinstance(mesh_or_path, str) else mesh_or_path
        self.triangles = jnp.asarray(_pad_triangles(mesh.triangles.astype(np.float32), 64))
        rw, rh = render_size or (globals_.width, globals_.height)
        self.render_wh = (rw, rh)
        self.K_render = jnp.array(
            [
                [globals_.focal_length_x * rw / globals_.width, 0, rw / 2.0],
                [0, globals_.focal_length_y * rh / globals_.height, rh / 2.0],
                [0, 0, 1.0],
            ],
            jnp.float32,
        )
        # Sensor-frame intrinsics (unscaled): the organized scene cloud is
        # frame-sized, so its normals must NOT use K_render's focals.
        self.K_frame = jnp.array(
            [
                [globals_.focal_length_x, 0, globals_.width / 2.0],
                [0, globals_.focal_length_y, globals_.height / 2.0],
                [0, 0, 1.0],
            ],
            jnp.float32,
        )

        # Device-side bank metadata.
        self.q_bank = jnp.asarray(
            np.asarray(geo.quat_from_matrix(jnp.asarray(metadata.R))), jnp.float32
        )
        self.T_bank = jnp.asarray(metadata.T, jnp.float32)
        self.D_bank = jnp.asarray(metadata.D, jnp.float32)
        self.Od_bank = jnp.asarray(metadata.Ori_dist, jnp.float32)
        self.Rect_bank = jnp.asarray(metadata.Rect, jnp.int32)

        self._pose_stage = jax.jit(self._build_pose_stage())

    # ------------------------------------------------------------------

    def _build_pose_stage(self):
        p = self.params
        tris = self.triangles
        K_render = self.K_render
        render_wh = self.render_wh

        def run(matches: M.Matches, cloud: jnp.ndarray):
            # Organized per-pixel scene normals for point-to-plane ICP:
            # computed ONCE per frame from the organized cloud (LS plane
            # fit over the 8-neighbourhood, camera-oriented).
            if p.icp_variant == "point_to_plane":
                from ..ops.verification import depth_normals

                depth_mm = jnp.where(
                    jnp.isfinite(cloud[..., 2]), cloud[..., 2], 0.0
                ) * 1000.0
                # FRAME-scale intrinsics, not K_render: the organized cloud
                # is sensor-sized, and K_render's focal lengths are scaled
                # by render_size/globals.width — using them here would
                # silently tilt every scene normal when render_size differs
                # from the sensor frame.
                scene_normals = depth_normals(depth_mm, self.K_frame)
            else:
                scene_normals = None
            clusters = CC.cluster_matches(
                matches,
                self.Od_bank,
                self.Rect_bank,
                self.globals.radius_min,
                self.globals.radius_step,
                p.clustering_step,
                p.cluster_filter_thresh,
                p.max_cells,
                p.members_cap,
            )
            if p.nms_after_pose:
                # Defer suppression: pose + verify every top cluster first,
                # then IoU-suppress ranked by occupancy (a symmetric flip
                # can out-score the true orientation but not out-verify it).
                # A loose pre-pose NMS would wrongly kill the flips (same
                # location, IoU ~1), so instead DOUBLE the pose slots: raw
                # match score alone ranks the truncation here, and several
                # near-duplicate clusters of one strong object must not
                # crowd a weaker second instance out of every slot.
                keep = clusters.valid
                n_slots = 2 * p.max_clusters
            else:
                keep = CC.nms_iou(clusters, p.iou_threshold)
                n_slots = p.max_clusters
            alive = clusters.valid & keep
            # Top clusters by score.
            order = jnp.argsort(-jnp.where(alive, clusters.score, -jnp.inf))[:n_slots]
            c_valid = alive[order]
            c_score = clusters.score[order]
            midx = clusters.member_idx[order]  # (C, M)
            mval = clusters.member_valid[order]

            tids = matches.template_id[midx]
            mq = self.q_bank[tids]
            mT = self.T_bank[tids]
            mD = self.D_bank[tids]
            mOd = self.Od_bank[tids]
            mx = matches.x[midx].astype(jnp.float32)
            my = matches.y[midx].astype(jnp.float32)
            ms = matches.similarity[midx].astype(jnp.float32)

            f = partial(
                CC.rough_pose_and_refine,
                params=p,
                render_wh=render_wh,
            )
            poses = jax.vmap(
                lambda q, T, D, Od, x, y, sim, mv, cv, cs: f(
                    q, T, D, Od, x, y, sim, mv, cv, cs,
                    cloud=cloud, triangles=tris, K_render=K_render,
                    scene_normals=scene_normals,
                )
            )(mq, mT, mD, mOd, mx, my, ms, mval, c_valid, c_score)
            if p.nms_after_pose:
                keep2 = CC.nms_rects(
                    poses.rect,
                    poses.hyp_sim + poses.hv_rate - 1e4 * poses.icp_fitness,
                    poses.valid, p.iou_threshold,
                )
                poses = poses._replace(valid=poses.valid & keep2)
            return poses, clusters, keep, order

        return run

    # ------------------------------------------------------------------

    def detect(
        self,
        rgb: np.ndarray,
        cloud: np.ndarray,
        threshold: float = 91.0,
        depth_mm: np.ndarray | None = None,
        return_stages: bool = False,
    ):
        """Run the full cascade on one frame; returns verified detections
        sorted by score (empty list = 'no object', the service's identity-
        pose case, service.cpp:1832-1846).

        With return_stages=True, returns (detections, StageOutputs) so every
        stage is inspectable, mirroring the reference's per-stage
        visualization hooks (C23)."""
        if depth_mm is None and self.detector.params.use_depth_normal:
            # The DepthNormal modality reads the cloud's depth, as the
            # reference's pc2depth conversion does (uint16 mm, NaN -> 0).
            from ..utils.pointcloud import cloud_to_depth_mm

            depth_mm = np.asarray(cloud_to_depth_mm(jnp.asarray(cloud)),
                                  np.float32)
        matches = self.detector.match_raw(
            rgb, threshold, depth_mm=depth_mm, class_ids=[self.class_id],
            top_k=self.params.max_matches,
        )[self.class_id]
        poses, clusters, keep, order = self._pose_stage(
            matches, jnp.asarray(cloud, jnp.float32)
        )

        out: list[Detection] = []
        valid = np.asarray(poses.valid)
        for i in np.nonzero(valid)[0]:
            out.append(
                Detection(
                    pose=np.asarray(poses.pose[i]),
                    rect=tuple(int(v) for v in np.asarray(poses.rect[i])),
                    score=float(poses.score[i]),
                    icp_fitness=float(poses.icp_fitness[i]),
                    hv_rate=float(poses.hv_rate[i]),
                    rough_pose=np.asarray(poses.rough_pose[i]),
                    icp_iterations=int(poses.icp_iterations[i]),
                )
            )
        out.sort(key=lambda d: -d.score)
        if return_stages:
            stages = StageOutputs(
                matches=matches,
                clusters=clusters,
                nms_keep=np.asarray(keep),
                cluster_order=np.asarray(order),
                poses=poses,
            )
            return out, stages
        return out

    def draw_response(
        self, rgb: np.ndarray, matches: M.Matches, max_draw: int = 8
    ) -> np.ndarray:
        """Feature-dot overlay of matched templates (drawResponse,
        service.cpp:723-748): each valid match's level-0 features are
        painted at (match.x + fx, match.y + fy), colored by template slot.
        """
        from ..utils.visualization import draw_features

        palette = [(0, 255, 0), (255, 0, 0), (0, 0, 255), (255, 255, 0),
                   (255, 0, 255), (0, 255, 255), (255, 128, 0), (128, 0, 255)]
        img = np.array(rgb, copy=True)
        feats0 = self.detector.bank(self.class_id).merged_features(0)
        ok = np.nonzero(np.asarray(matches.valid))[0][:max_draw]
        for slot, i in enumerate(ok):
            t = int(matches.template_id[i])
            offs = np.asarray(feats0.offsets[t])[np.asarray(feats0.live[t])]
            img = draw_features(
                img, offs, (int(matches.x[i]), int(matches.y[i])),
                palette[slot % len(palette)],
            )
        return img

    @classmethod
    def from_files(
        cls,
        templates_yml: str,
        params_yml: str,
        stl_path: str,
        cascade_params: CC.CascadeParams | None = None,
        render_size: tuple[int, int] | None = None,
    ) -> "DetectionPipeline":
        """Cold-start from serialized banks, like the reference nodes' ctors
        (service.cpp:224-247)."""
        det = Detector.read(templates_yml)
        meta, glob = TemplateBank.read_params_yaml(params_yml)
        return cls(det, meta, glob, stl_path, cascade_params, render_size=render_size)
