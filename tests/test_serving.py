"""Batched serving + carmine extras."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linemod_pose_estimation.models.serving import look_at_point


def test_look_at_point_center_and_fallback():
    cloud = np.full((40, 60, 3), np.nan, np.float32)
    cloud[10:30, 20:50] = [0.1, 0.2, 0.6]
    # bbox centered in valid region -> exact center point.
    p = np.asarray(look_at_point(jnp.asarray(cloud), (20, 10, 30, 20)))
    np.testing.assert_allclose(p, [0.1, 0.2, 0.6], atol=1e-6)
    # bbox whose center is NaN but containing valid points -> fallback point.
    cloud2 = np.full((40, 60, 3), np.nan, np.float32)
    cloud2[10:12, 20:22] = [0.3, 0.1, 0.5]
    p2 = np.asarray(look_at_point(jnp.asarray(cloud2), (18, 8, 10, 10)))
    np.testing.assert_allclose(p2, [0.3, 0.1, 0.5], atol=1e-6)


def test_graft_entry_compiles_single_chip():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256,)
    assert np.isfinite(np.asarray(out)).all()


def test_batched_matcher_consistent_with_single(rng):
    """BatchedMatcher must agree with per-frame match on identical frames."""
    import sys

    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.serving import BatchedMatcher
    from linemod_pose_estimation.models.templates import DetectorParams

    sys.path.insert(0, "tests")
    from test_match import make_object_patch, plant

    patch, mask = make_object_patch(rng)
    src = plant((120, 160, 3), patch, (30, 50))
    src_mask = plant((120, 160), mask, (30, 50))
    det = Detector(DetectorParams(), engine="gather")
    assert det.add_template(src, src_mask, "obj") == 0

    bm = BatchedMatcher(det, "obj", threshold=90.0, batch=2, top_k=16)
    frames = np.stack([src, plant((120, 160, 3), patch, (44, 62))])
    res = bm.match_batch_list(jnp.asarray(frames))
    assert len(res) == 2
    rx0, ry0 = det.template_rect0("obj", 0)[:2]
    # Matches report the cropped-template bbox origin; frame 1's plant is
    # shifted by (+12, +14) from frame 0's.
    for b, (sx, sy) in enumerate([(0, 0), (12, 14)]):
        m = res[b]
        ok = np.asarray(m.valid)
        assert ok.any()
        sims = np.asarray(m.similarity)[ok]
        assert sims.max() >= 99.0
        best = int(np.argmax(np.where(ok, np.asarray(m.similarity), -1.0)))
        # T0-grid reporting (cv::linemod walk): within 2 px of the plant.
        assert abs(int(m.x[best]) - (rx0 + sx)) <= 2
        assert abs(int(m.y[best]) - (ry0 + sy)) <= 2


def test_streaming_multicamera_batched_inference(rng):
    """BASELINE config 'streaming multi-camera batched inference':
    FrameBatcher round-robins N camera sources into device batches, the
    global batch shards over the mesh data axis (DCN ingest seam), and
    BatchedMatcher finds each camera's planted object per step."""
    import jax
    import sys

    sys.path.insert(0, "tests")
    from test_match import make_object_patch, plant

    from linemod_pose_estimation.api.service import Frame
    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.serving import BatchedMatcher
    from linemod_pose_estimation.models.templates import DetectorParams
    from linemod_pose_estimation.parallel.ingest import FrameBatcher, put_global_batch
    from linemod_pose_estimation.parallel.mesh import make_mesh

    patch, mask = make_object_patch(rng)
    src = plant((120, 160, 3), patch, (30, 50))
    src_mask = plant((120, 160), mask, (30, 50))
    det = Detector(DetectorParams(), engine="gather")
    assert det.add_template(src, src_mask, "obj") == 0
    rx0, ry0 = det.template_rect0("obj", 0)[:2]

    # 3 "cameras", each seeing the object at a different place.
    shifts = [(0, 0), (12, 8), (-20, 24)]
    cams = []
    for sx, sy in shifts:
        rgb = plant((120, 160, 3), patch, (30 + sy, 50 + sx))
        cloud = np.zeros((120, 160, 3), np.float32)
        cams.append(Frame(rgb=rgb, cloud=cloud))

    fb = FrameBatcher([lambda f=f: f for f in cams], batch=4)
    mesh = make_mesh(data=2, bank=4)
    bm = BatchedMatcher(det, "obj", threshold=90.0, batch=4, top_k=16)

    for step in range(2):
        rgbs, clouds = fb.next_batch()
        g_rgbs, _ = put_global_batch(mesh, rgbs)
        results = bm.match_batch_list(jnp.asarray(g_rgbs))
        for b, m in enumerate(results):
            cam = (step * 4 + b) % 3
            sx, sy = shifts[cam]
            ok = np.asarray(m.valid)
            assert ok.any(), (step, b)
            best = int(np.argmax(np.where(ok, np.asarray(m.similarity), -1.0)))
            assert float(m.similarity[best]) >= 99.0
            assert abs(int(m.x[best]) - (rx0 + sx)) <= 2, (step, b)
            assert abs(int(m.y[best]) - (ry0 + sy)) <= 2, (step, b)
