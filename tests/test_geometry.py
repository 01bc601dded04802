import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linemod_pose_estimation.utils import geometry as geo


def random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.asarray(geo.quat_to_matrix(jnp.asarray(q)))


def test_quat_matrix_roundtrip(rng):
    for _ in range(50):
        R = random_rotation(rng)
        q = geo.quat_from_matrix(jnp.asarray(R))
        R2 = geo.quat_to_matrix(q)
        np.testing.assert_allclose(np.asarray(R2), R, atol=1e-5)


def test_quat_from_matrix_batched(rng):
    Rs = np.stack([random_rotation(rng) for _ in range(8)])
    qs = geo.quat_from_matrix(jnp.asarray(Rs))
    assert qs.shape == (8, 4)
    R2 = geo.quat_to_matrix(qs)
    np.testing.assert_allclose(np.asarray(R2), Rs, atol=1e-5)


def test_geodesic_distance_known_angle():
    Rz = lambda a: np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    )
    for deg in [0.0, 5.0, 10.0, 90.0, 179.0]:
        d = geo.rotation_geodesic_deg(jnp.asarray(np.eye(3)), jnp.asarray(Rz(np.radians(deg))))
        np.testing.assert_allclose(float(d), deg, atol=1e-3)


def test_quat_average_of_cluster(rng):
    # Rotations within a few degrees of a base: average stays in cluster.
    base = random_rotation(rng)
    Rs = []
    for _ in range(10):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(rng.uniform(0, 3.0))
        K = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        Rd = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
        Rs.append(Rd @ base)
    qs = geo.quat_from_matrix(jnp.asarray(np.stack(Rs)))
    # Randomize hemispheres; averaging must be sign-invariant.
    signs = rng.choice([-1.0, 1.0], size=(10, 1))
    q_avg = geo.quat_average(jnp.asarray(np.asarray(qs) * signs))
    R_avg = geo.quat_to_matrix(q_avg)
    d = geo.rotation_geodesic_deg(jnp.asarray(base), R_avg)
    assert float(d) < 3.0


def test_transforms_compose(rng):
    R = random_rotation(rng)
    t = rng.normal(size=3)
    T = geo.make_transform(jnp.asarray(R), jnp.asarray(t))
    Ti = geo.invert_transform(T)
    np.testing.assert_allclose(np.asarray(T @ Ti), np.eye(4), atol=1e-5)
    pts = rng.normal(size=(17, 3)).astype(np.float32)
    out = geo.transform_points(T, jnp.asarray(pts))
    np.testing.assert_allclose(np.asarray(out), pts @ R.T + t, atol=1e-4)


def test_look_at_matches_shipped_bank_convention():
    """Row 2 of R must be the unit vector along T (camera -> origin), and the
    reference's up reconstruction (-row1) must reproduce R exactly."""
    from conftest import BANK_PARAMS
    from linemod_pose_estimation.models.templates import _maybe_ungz
    from linemod_pose_estimation.utils import opencv_yaml as oy

    doc = oy.load(_maybe_ungz(BANK_PARAMS))
    for i in [0, 1, 500, 2651]:
        t = doc[f"Template {i}"]
        R, T = t["R"], t["T"].ravel()
        fwd = T / np.linalg.norm(T)
        np.testing.assert_allclose(R[2], fwd, atol=1e-6)
        up = -R[1]  # reference: up = -col1(R^T) = -row1(R)  (rgbdDetector.cpp:649-651)
        R2 = geo.look_at_object(jnp.asarray(-T), jnp.asarray(up))
        np.testing.assert_allclose(np.asarray(R2), R, atol=1e-5)
