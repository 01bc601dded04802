import jax.numpy as jnp
import numpy as np

from linemod_pose_estimation.utils import pointcloud as pc
from linemod_pose_estimation.utils.geometry import make_K


def test_depth_cloud_roundtrip(rng):
    K = make_K(535.566, 537.168, 320, 240)
    depth = rng.uniform(0.4, 1.0, size=(48, 64)).astype(np.float32)
    depth[:5, :5] = 0.0
    cloud = pc.depth_to_cloud(jnp.asarray(depth), K)
    assert np.isnan(np.asarray(cloud[0, 0])).all()
    back = pc.cloud_to_depth_mm(cloud)
    np.testing.assert_allclose(
        np.asarray(back)[5:, 5:], (depth[5:, 5:] * 1000).astype(np.uint16), atol=1
    )


def test_extract_rect_points():
    K = make_K(100.0, 100.0, 32, 24)
    depth = np.full((48, 64), 0.5, np.float32)
    cloud = pc.depth_to_cloud(jnp.asarray(depth), K)
    rect = jnp.array([10, 12, 6, 4])
    pts, valid = pc.extract_rect_points(cloud, rect, cap=64)
    assert int(valid.sum()) == 24
    # All extracted z == 0.5
    z = np.asarray(pts)[np.asarray(valid), 2]
    np.testing.assert_allclose(z, 0.5)


def test_extract_rect_with_mask_and_bias():
    K = make_K(100.0, 100.0, 40, 24)
    depth = np.full((48, 80), 0.7, np.float32)
    cloud = pc.depth_to_cloud(jnp.asarray(depth), K)
    mask = np.zeros((48, 80), np.uint8)
    mask[12:14, 10:13] = 255  # 6 pixels, image coords
    pts, valid = pc.extract_rect_points(
        cloud, jnp.array([8, 10, 10, 10]), cap=32, mask=jnp.asarray(mask), bias_x=5
    )
    assert int(valid.sum()) == 6
    # Extracted x coords correspond to cloud cols 15..17 (bias applied).
    u = np.sort(np.asarray(pts)[np.asarray(valid), 0])
    expect = (np.array([15, 15, 16, 16, 17, 17]) - 40) * 0.7 / 100.0
    np.testing.assert_allclose(u, np.sort(expect), atol=1e-6)


def test_statistical_outlier_removal(rng):
    pts = rng.normal(size=(200, 3)).astype(np.float32) * 0.01
    pts[0] = [5.0, 5.0, 5.0]  # gross outlier
    valid = np.ones(200, bool)
    out = pc.statistical_outlier_removal(jnp.asarray(pts), jnp.asarray(valid), 50, 1.0)
    out = np.asarray(out)
    assert not out[0]
    assert out[1:].mean() > 0.7


def test_voxel_grid_filter():
    # Two well-separated blobs (safely interior to their voxels) -> 2 voxels.
    pts = np.array(
        [[0.003, 0.003, 0.003], [0.005, 0.002, 0.003], [0.104, 0.105, 0.103], [0.106, 0.104, 0.103]],
        np.float32,
    )
    valid = np.ones(4, bool)
    out, ov = pc.voxel_grid_filter(jnp.asarray(pts), jnp.asarray(valid), leaf=0.01, cap=4)
    out, ov = np.asarray(out), np.asarray(ov)
    assert ov.sum() == 2
    got = out[ov]
    np.testing.assert_allclose(sorted(got[:, 0]), [0.004, 0.105], atol=1e-5)


def test_voxel_occupancy_rate():
    # Scene points at voxel centers; hits perturbed < res/2, misses far away.
    scene = np.array([[0.002, 0.002, 0.502], [0.014, 0.002, 0.502], [0.026, 0.002, 0.502]],
                     np.float32)
    model_hit = scene + 0.001
    model_miss = scene + np.array([0.5, 0.5, 0.5], np.float32)
    model = np.concatenate([model_hit, model_miss])
    rate = pc.voxel_occupancy_rate(
        jnp.asarray(model), jnp.ones(6, bool), jnp.asarray(scene), jnp.ones(3, bool), 0.004
    )
    np.testing.assert_allclose(float(rate), 0.5, atol=1e-6)


def test_nearest_point_and_centroid():
    pts = np.array([[0, 0, 0], [1, 1, 1], [2, 2, 2]], np.float32)
    valid = np.array([True, False, True])
    c = pc.masked_centroid(jnp.asarray(pts), jnp.asarray(valid))
    np.testing.assert_allclose(np.asarray(c), [1, 1, 1])
    np2 = pc.nearest_point(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray([0.9, 0.9, 0.9]))
    np.testing.assert_allclose(np.asarray(np2), [0, 0, 0])  # slot 1 invalid


def test_voxel_grid_filter_aux_averages():
    """aux rides the same per-voxel averaging as the points (normals for
    point-to-plane ICP)."""
    import jax.numpy as jnp
    pts = np.array([
        [0.001, 0.001, 0.0], [0.003, 0.002, 0.0],  # same 1 cm voxel
        [0.051, 0.001, 0.0],                        # another voxel
        [0.9, 0.9, 0.9],                            # invalid
    ], np.float32)
    aux = np.array([
        [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
        [0.0, 0.0, 2.0],
        [9.0, 9.0, 9.0],
    ], np.float32)
    valid = np.array([True, True, True, False])
    out, ov, oa = pc.voxel_grid_filter(
        jnp.asarray(pts), jnp.asarray(valid), leaf=0.01, cap=4,
        aux=jnp.asarray(aux),
    )
    ov = np.asarray(ov); out = np.asarray(out); oa = np.asarray(oa)
    assert ov.sum() == 2
    order = np.argsort(out[ov][:, 0])
    np.testing.assert_allclose(
        out[ov][order], [[0.002, 0.0015, 0.0], [0.051, 0.001, 0.0]], atol=1e-6
    )
    np.testing.assert_allclose(
        oa[ov][order], [[0.5, 0.5, 0.0], [0.0, 0.0, 2.0]], atol=1e-6
    )
