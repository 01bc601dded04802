import jax.numpy as jnp
import numpy as np

from linemod_pose_estimation.ops import filters as FL
from linemod_pose_estimation.ops import icp as I


def test_rgb_to_hsv_known_colors():
    rgb = jnp.asarray(np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 255]],
                               np.uint8))
    hsv = np.asarray(FL.rgb_to_hsv_u8(rgb))
    np.testing.assert_allclose(hsv[0], [0, 255, 255], atol=1)
    np.testing.assert_allclose(hsv[1], [60, 255, 255], atol=1)
    np.testing.assert_allclose(hsv[2], [120, 255, 255], atol=1)
    np.testing.assert_allclose(hsv[3][1:], [0, 255], atol=1)


def test_hsv_color_filter_gate():
    img = np.zeros((20, 20, 3), np.uint8)
    img[10, 10] = [0, 200, 0]  # green center
    rect = jnp.array([5, 5, 10, 10])
    ok = FL.hsv_color_filter(jnp.asarray(img), rect, h_range=(50, 70), s_range=(100, 255),
                             v_range=(100, 255))
    assert bool(ok)
    ok2 = FL.hsv_color_filter(jnp.asarray(img), rect, h_range=(0, 20))
    assert not bool(ok2)


def test_absolute_rectangle():
    g = np.zeros((30, 40), np.float32)
    g[10:15, 20:28] = 200.0
    rect = np.asarray(FL.absolute_rectangle(jnp.asarray(g), jnp.array([0, 0, 40, 30])))
    assert rect.tolist() == [20, 10, 8, 5]
    # ROI excluding the blob -> zeros
    rect2 = np.asarray(FL.absolute_rectangle(jnp.asarray(g), jnp.array([0, 0, 10, 10])))
    assert rect2.tolist() == [0, 0, 0, 0]


def test_nms_distance():
    cells = jnp.asarray(np.array([[2, 2, 0], [3, 3, 0], [10, 10, 0]], np.int32))
    scores = jnp.asarray(np.array([95.0, 90.0, 80.0], np.float32))
    valid = jnp.ones(3, bool)
    keep = np.asarray(FL.nms_distance(cells, scores, valid, neighbor_size=2))
    assert keep.tolist() == [True, False, True]


def test_icp_schedule_three_pass(rng):
    pts = rng.uniform(-0.03, 0.03, (128, 3)).astype(np.float32)
    t = np.array([0.01, -0.005, 0.008], np.float32)
    scene = pts + t
    v = np.ones(128, bool)
    res = I.icp_schedule(
        jnp.asarray(pts), jnp.asarray(v), jnp.asarray(scene), jnp.asarray(v),
        stages=((50, 0.05, 0.02, 1e-5), (20, 0.01, 0.01, 1e-6), (10, 0.005, 0.005, 1e-7)),
    )
    np.testing.assert_allclose(np.asarray(res.transform)[:3, 3], t, atol=1e-4)
