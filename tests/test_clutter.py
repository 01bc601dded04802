"""Clutter / capacity robustness (VERDICT r2 item 6).

The reference processes unbounded match lists at threshold 0
(linemod_carmine_detect.cpp:395) and unbounded vote maps
(rgbdDetector.cpp:36-70); our cascade replaces them with fixed-capacity
padded arrays (CascadeParams max_matches / max_cells / members_cap /
max_clusters).  These tests plant TWO object instances plus distractor
texture and partial occlusion into one 640x480 frame and assert that

  (a) the capacity-padded cascade still finds both instances, and
  (b) doubling every capacity does not change the result (truncation-
      insensitivity at production capacities).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from linemod_pose_estimation.models import cascade as CC
from linemod_pose_estimation.models.detector import Detector
from linemod_pose_estimation.models.pipeline import DetectionPipeline
from linemod_pose_estimation.models.renderer import Renderer
from linemod_pose_estimation.models.templates import (
    DetectorParams, TemplateBank, TemplateMetadata,
)
from linemod_pose_estimation.utils import pointcloud as pcu

from conftest import BANK_PARAMS, BOX_STL

STL = BOX_STL
W, H = 640, 480
BG_MM = 1500.0


@pytest.fixture(scope="module")
def scene():
    """640x480 cluttered two-instance scene + its organized cloud + the
    trained detector/bank (full reference geometry)."""
    meta_full, glob = TemplateBank.read_params_yaml(BANK_PARAMS)
    r = Renderer(STL, W, H, glob.focal_length_x, glob.focal_length_y)
    ids = [40, 700, 1400, 2000]
    det = Detector(DetectorParams())
    kept = []
    for i in ids:
        out = r.render(meta_full.R[i], meta_full.T[i])
        if det.add_template(np.asarray(out.rgb), np.asarray(out.mask), "boxNew") >= 0:
            kept.append(i)
    assert len(kept) >= 3
    meta = TemplateMetadata(
        R=meta_full.R[kept], T=meta_full.T[kept], K=meta_full.K[kept],
        D=meta_full.D[kept], Ori_dist=meta_full.Ori_dist[kept],
        Rect=meta_full.Rect[kept],
    )

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (40 + 60 * yy / H + 30 * np.sin(xx / 190.0)).astype(np.uint8)
    rgb = np.stack([base, (base * 0.9).astype(np.uint8),
                    np.clip(base * 1.1, 0, 255).astype(np.uint8)], -1)
    depth = np.full((H, W), BG_MM, np.float32)
    # Heavy distractor clutter: flat boxes + high-frequency texture patches
    # (many strong gradients -> many raw matches competing for capacity).
    for _ in range(6):
        y0, x0 = int(rng.integers(0, H - 90)), int(rng.integers(0, W - 130))
        rgb[y0:y0 + 90, x0:x0 + 130] = rng.integers(50, 180, size=3)
        depth[y0:y0 + 90, x0:x0 + 130] = float(rng.uniform(1200, 1800))
    for _ in range(4):
        y0, x0 = int(rng.integers(0, H - 64)), int(rng.integers(0, W - 64))
        rgb[y0:y0 + 64, x0:x0 + 64] = rng.integers(0, 255, size=(64, 64, 3),
                                                   dtype=np.uint8)

    # Two instances of trained views, one partially occluded.
    truths = []
    for k, (vid, occlude) in enumerate([(0, False), (1, True)]):
        out = r.render(meta.R[vid], meta.T[vid])
        v_rgb = np.asarray(out.rgb)
        v_depth = np.asarray(out.depth_mm).astype(np.float32)
        mask = np.asarray(out.mask) > 0
        x, y, w, h = (int(v) for v in np.asarray(out.rect))
        dy = (-y + 40) if k == 0 else (H - (y + h) - 40)
        dx = (-x + 60) if k == 0 else (W - (x + w) - 60)
        sub = mask[y:y + h, x:x + w].copy()
        if occlude:
            bar = max(1, int(0.15 * h))
            sub[:bar] = False
        tgt = np.s_[y + dy:y + dy + h, x + dx:x + dx + w]
        rgb[tgt][sub] = v_rgb[y:y + h, x:x + w][sub]
        depth[tgt][sub] = v_depth[y:y + h, x:x + w][sub]
        truths.append((x + dx, y + dy))

    glob2 = glob
    cloud = np.asarray(pcu.depth_to_cloud(jnp.asarray(depth) / 1000.0, r.K))
    return det, meta, glob2, rgb, cloud, truths


def _detect(scene, caps_scale=1):
    det, meta, glob, rgb, cloud, truths = scene
    p = CC.CascadeParams(
        canonicalize="none",
        cluster_filter_thresh=0,
        max_matches=512 * caps_scale,
        max_cells=64 * caps_scale,
        members_cap=64 * caps_scale,
        max_clusters=4 * caps_scale,
        icp_max_iter=40,
    )
    pipe = DetectionPipeline(det, meta, glob, STL, p, render_size=(W, H))
    return pipe.detect(rgb, cloud, threshold=84.0), truths


@pytest.mark.slow
def test_two_instances_found_in_clutter(scene):
    dets, truths = _detect(scene)
    assert len(dets) >= 2, f"expected both instances, got {len(dets)}"
    for tx, ty in truths:
        hit = any(abs(d.rect[0] - tx) <= 12 and abs(d.rect[1] - ty) <= 12
                  for d in dets)
        assert hit, f"planted instance at ({tx},{ty}) not found: " \
                    f"{[(d.rect[0], d.rect[1]) for d in dets]}"


@pytest.mark.slow
def test_capacity_truncation_insensitive(scene):
    """Doubling every fixed capacity must not change what is found."""
    dets1, truths = _detect(scene, caps_scale=1)
    dets2, _ = _detect(scene, caps_scale=2)

    def key(ds):
        return sorted((round(d.rect[0] / 4), round(d.rect[1] / 4)) for d in ds)

    assert len(dets1) == len(dets2)
    assert key(dets1) == key(dets2)
    for tx, ty in truths:
        assert any(abs(d.rect[0] - tx) <= 12 and abs(d.rect[1] - ty) <= 12
                   for d in dets2)
