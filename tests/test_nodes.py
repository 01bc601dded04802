"""Node analogs: replay sources, streaming/polling detectors, viz utils."""

import numpy as np
import pytest

from linemod_pose_estimation.api.nodes import (
    ReplayFrameSource,
    load_pcd_ascii,
    save_replay_frame,
)
from linemod_pose_estimation.utils.visualization import (
    StageTimer,
    draw_features,
    draw_rect,
    write_png,
)


def test_replay_roundtrip(tmp_path, rng):
    rgb = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    cloud = rng.normal(size=(24, 32, 3)).astype(np.float32)
    save_replay_frame(str(tmp_path / "f0.npz"), rgb, cloud)
    save_replay_frame(str(tmp_path / "f1.npz"), rgb + 1, cloud)
    src = ReplayFrameSource(str(tmp_path))
    f0 = src()
    f1 = src()
    f2 = src()  # wraps around
    np.testing.assert_array_equal(f0.rgb, rgb)
    np.testing.assert_array_equal(f1.rgb, rgb + 1)
    np.testing.assert_array_equal(f2.rgb, f0.rgb)


def test_pcd_ascii_reader(tmp_path):
    p = tmp_path / "c.pcd"
    p.write_text(
        "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
        "COUNT 1 1 1\nWIDTH 2\nHEIGHT 2\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 4\n"
        "DATA ascii\n"
        "0.1 0.2 0.5\n0.2 0.2 0.5\nnan nan nan\n0.2 0.3 0.5\n"
    )
    cloud = load_pcd_ascii(str(p))
    assert cloud.shape == (2, 2, 3)
    np.testing.assert_allclose(cloud[0, 0], [0.1, 0.2, 0.5])
    assert np.isnan(cloud[1, 0]).all()


def test_png_writer_and_overlays(tmp_path, rng):
    img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
    out = draw_rect(img, (5, 5, 20, 15), color=(255, 0, 0))
    assert (out[5, 5:25] == [255, 0, 0]).all()
    feats = np.array([[2, 3, 0], [8, 9, 4]], np.int32)
    out2 = draw_features(out, feats, origin_xy=(5, 5))
    assert (out2[7, 8] == [0, 255, 0]).all()
    p = str(tmp_path / "viz.png")
    write_png(p, out2)
    cv2 = pytest.importorskip("cv2")
    back = cv2.imread(p)[:, :, ::-1]  # BGR -> RGB
    np.testing.assert_array_equal(back, out2)


def test_stage_timer():
    t = StageTimer()
    with t.stage("match"):
        x = sum(range(1000))
    with t.stage("icp"):
        pass
    assert "match" in t.times and "icp" in t.times
    assert "match" in t.report()
