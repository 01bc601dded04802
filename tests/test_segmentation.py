import jax.numpy as jnp
import numpy as np

from linemod_pose_estimation.models.grasp import grasping_pose_region_growing
from linemod_pose_estimation.ops import segmentation as seg


def two_planes(rng, n_each=150, gap=0.3):
    """Two flat patches: one big horizontal (z=0.5), one small vertical."""
    a = np.zeros((n_each, 3), np.float32)
    a[:, 0] = rng.uniform(0, 0.2, n_each)
    a[:, 1] = rng.uniform(0, 0.2, n_each)
    a[:, 2] = 0.5
    b = np.zeros((n_each // 3, 3), np.float32)
    b[:, 0] = gap + rng.uniform(0, 0.05, n_each // 3)
    b[:, 2] = 0.5 + rng.uniform(0, 0.05, n_each // 3)
    b[:, 1] = 0.1
    return a, b


def test_estimate_normals_flat_plane(rng):
    a, _ = two_planes(rng)
    valid = np.ones(len(a), bool)
    normals, curv = seg.estimate_normals(jnp.asarray(a), jnp.asarray(valid), k=20)
    nz = np.abs(np.asarray(normals)[:, 2])
    assert np.mean(nz > 0.99) > 0.95  # flat plane -> +-z normals
    assert np.median(np.asarray(curv)) < 0.01
    # Oriented toward viewpoint at origin: n . p < 0 => nz negative.
    assert np.mean(np.asarray(normals)[:, 2] < 0) > 0.9


def test_euclidean_cluster_largest(rng):
    a, b = two_planes(rng)
    pts = np.concatenate([a, b])
    valid = np.ones(len(pts), bool)
    mask = np.asarray(
        seg.euclidean_cluster_largest(jnp.asarray(pts), jnp.asarray(valid), tolerance=0.05)
    )
    assert mask[: len(a)].all()
    assert not mask[len(a):].any()


def test_region_growing_splits_by_normal(rng):
    # A horizontal and a vertical plane touching at an edge: euclidean would
    # merge them, region growing must not.
    n = 200
    a = np.zeros((n, 3), np.float32)
    a[:, 0] = rng.uniform(0, 0.1, n)
    a[:, 1] = rng.uniform(0, 0.1, n)
    a[:, 2] = 0.5
    b = np.zeros((n // 2, 3), np.float32)
    b[:, 0] = 0.1
    b[:, 1] = rng.uniform(0, 0.1, n // 2)
    b[:, 2] = 0.5 + rng.uniform(0.003, 0.1, n // 2)
    pts = np.concatenate([a, b])
    valid = np.ones(len(pts), bool)
    normals, curv = seg.estimate_normals(jnp.asarray(pts), jnp.asarray(valid), k=15)
    mask = np.asarray(
        seg.region_growing_largest(
            jnp.asarray(pts), jnp.asarray(valid), normals, curv,
            smoothness_deg=10.0, curvature_thresh=0.05, k=10,
        )
    )
    # Largest region = the horizontal plane, mostly pure.
    assert mask[:n].mean() > 0.8
    assert mask[n:].mean() < 0.2


def test_mls_smooth_reduces_noise(rng):
    a, _ = two_planes(rng, n_each=300)
    noisy = a + rng.normal(scale=0.002, size=a.shape).astype(np.float32) * np.array([0, 0, 1], np.float32)
    valid = np.ones(len(a), bool)
    sm = np.asarray(seg.mls_smooth(jnp.asarray(noisy), jnp.asarray(valid), radius=0.05))
    assert np.std(sm[:, 2]) < np.std(noisy[:, 2]) * 0.7


def test_grasp_pose_on_flat_surface(rng):
    a, _ = two_planes(rng, n_each=300)
    valid = np.ones(len(a), bool)
    pose, region = grasping_pose_region_growing(
        jnp.asarray(a), jnp.asarray(valid), normal_thresh_deg=8.0,
        curvature_thresh=0.1, offset=0.05,
    )
    pose = np.asarray(pose)
    assert np.asarray(region).sum() > 200
    # Surface normal ~ -z (toward camera); grasp position backed off along
    # the normal: z ~ 0.5 + 0.05.
    np.testing.assert_allclose(pose[2, 3], 0.55, atol=0.02)
    # Approach axis (pose z) should align with the anti-normal (+z here).
    np.testing.assert_allclose(np.abs(pose[2, 2]), 1.0, atol=0.05)
    # Rotation is orthonormal.
    np.testing.assert_allclose(pose[:3, :3] @ pose[:3, :3].T, np.eye(3), atol=1e-5)
