"""SHOT + Hough-3D local-descriptor pose path (getPoseByLocalDescriptor,
rgbdDetector.cpp:867-1000): recover a 6D pose WITHOUT ICP."""

import numpy as np
import jax.numpy as jnp

from linemod_pose_estimation.ops import local_descriptor as LD


def make_asymmetric_cloud(rng, n=400):
    """An L-shaped slab surface — asymmetric so LRFs disambiguate."""
    pts = []
    # horizontal plate
    pts.append(np.stack([rng.uniform(0, 0.08, n // 2), rng.uniform(0, 0.03, n // 2),
                         0.002 * rng.standard_normal(n // 2)], axis=1))
    # vertical wing at one end
    pts.append(np.stack([rng.uniform(0, 0.02, n // 2), rng.uniform(0, 0.03, n // 2),
                         rng.uniform(0, 0.05, n // 2)], axis=1))
    return np.concatenate(pts).astype(np.float32)


def rot(axis, deg):
    axis = np.asarray(axis, np.float64); axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(np.float32)


def test_shot_descriptor_rigid_invariance(rng):
    pts = make_asymmetric_cloud(rng)
    valid = np.ones(len(pts), bool)
    R = rot([0.3, 1.0, 0.2], 40.0)
    t = np.array([0.05, -0.02, 0.3], np.float32)
    pts2 = pts @ R.T + t

    from linemod_pose_estimation.ops.segmentation import estimate_normals

    n1, _ = estimate_normals(jnp.asarray(pts), jnp.asarray(valid), k=10)
    n2, _ = estimate_normals(jnp.asarray(pts2), jnp.asarray(valid), k=10)
    ki, kv = LD.select_keypoints(jnp.asarray(pts), jnp.asarray(valid), 0.01, 64)
    lrf1 = LD.local_reference_frames(jnp.asarray(pts), jnp.asarray(valid), ki, 0.015)
    d1 = LD.shot_descriptors(jnp.asarray(pts), jnp.asarray(valid), n1, ki, kv, lrf1, 0.02)
    # Same keypoints, transformed cloud.
    lrf2 = LD.local_reference_frames(jnp.asarray(pts2), jnp.asarray(valid), ki, 0.015)
    d2 = LD.shot_descriptors(jnp.asarray(pts2), jnp.asarray(valid), n2, ki, kv, lrf2, 0.02)
    nk = int(np.sum(np.asarray(kv)))
    # Descriptors are LRF-relative -> rigid-invariant (up to normal-sign and
    # disambiguation flips on near-symmetric supports); most must agree.
    sims = np.einsum("kd,kd->k", np.asarray(d1)[:nk], np.asarray(d2)[:nk])
    assert np.median(sims) > 0.9, sims


def test_recover_pose_without_icp(rng):
    model = make_asymmetric_cloud(rng)
    valid = np.ones(len(model), bool)
    R = rot([0.2, 0.5, 1.0], 35.0)
    t = np.array([0.04, 0.07, -0.02], np.float32)
    scene = model @ R.T + t

    res = LD.get_pose_by_local_descriptor(
        jnp.asarray(model), jnp.asarray(valid),
        jnp.asarray(scene), jnp.asarray(valid),
        min_votes=5,
    )
    assert bool(res.valid), (int(res.votes), int(res.n_correspondences))
    T = np.asarray(res.pose)
    R_err = T[:3, :3] @ R.T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    terr = np.linalg.norm(T[:3, 3] - t)
    assert ang < 3.0, f"rotation error {ang} deg"
    assert terr < 0.005, f"translation error {terr} m"


def test_no_pose_on_unrelated_scene(rng):
    model = make_asymmetric_cloud(rng)
    valid = np.ones(len(model), bool)
    scene = rng.uniform(-0.1, 0.1, size=model.shape).astype(np.float32)
    res = LD.get_pose_by_local_descriptor(
        jnp.asarray(model), jnp.asarray(valid),
        jnp.asarray(scene), jnp.asarray(valid),
        min_votes=8,
    )
    assert not bool(res.valid)
