import jax.numpy as jnp
import numpy as np

from linemod_pose_estimation.ops import icp as I
from linemod_pose_estimation.utils import geometry as geo


def make_model(rng, n=256):
    """A boxy point cloud (not rotation-symmetric)."""
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    pts *= np.array([0.05, 0.03, 0.015], np.float32)
    # project onto the box surface to mimic a depth-view cloud
    ax = rng.integers(0, 3, size=n)
    sgn = rng.choice([-1.0, 1.0], size=n)
    lim = np.array([0.05, 0.03, 0.015], np.float32)
    pts[np.arange(n), ax] = (sgn * lim[ax]).astype(np.float32)
    return pts


def rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def test_icp_recovers_small_pose_offset(rng):
    model = make_model(rng)
    R = rot([0.3, 1.0, 0.2], 8.0)
    t = np.array([0.012, -0.008, 0.01], np.float32)
    scene = (model @ R.T + t).astype(np.float32)
    valid = np.ones(model.shape[0], bool)
    res = I.icp(
        jnp.asarray(model), jnp.asarray(valid), jnp.asarray(scene), jnp.asarray(valid),
        max_iterations=100, max_corr_dist=0.05, rejection_dist=0.02,
    )
    T = np.asarray(res.transform)
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(T[:3, :3])))
    assert ang < 1.0, ang
    np.testing.assert_allclose(T[:3, 3], t, atol=1e-3)
    assert float(res.fitness) < 1e-6


def test_icp_two_stage_tightens(rng):
    model = make_model(rng)
    R = rot([1.0, 0.1, -0.4], 12.0)
    t = np.array([0.02, 0.015, -0.01], np.float32)
    scene = (model @ R.T + t).astype(np.float32)
    # Scene has extra outlier structure the model shouldn't latch onto.
    outliers = rng.uniform(0.1, 0.2, size=(64, 3)).astype(np.float32)
    scene_all = np.concatenate([scene, outliers])
    sv = np.ones(scene_all.shape[0], bool)
    mv = np.ones(model.shape[0], bool)
    res = I.icp_two_stage(
        jnp.asarray(model), jnp.asarray(mv), jnp.asarray(scene_all), jnp.asarray(sv),
        coarse_iterations=150, coarse_corr_dist=0.05, coarse_rejection=0.02,
        fine_iterations=20, fine_corr_dist=0.01, fine_rejection=0.01,
    )
    T = np.asarray(res.transform)
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(T[:3, :3])))
    assert ang < 1.5, ang
    np.testing.assert_allclose(T[:3, 3], t, atol=2e-3)


def test_icp_respects_validity_masks(rng):
    model = make_model(rng)
    scene = model.copy()
    mv = np.ones(model.shape[0], bool)
    # Append garbage invalid points that would wreck alignment if used.
    model_pad = np.concatenate([model, rng.uniform(5, 6, (64, 3)).astype(np.float32)])
    mv_pad = np.concatenate([mv, np.zeros(64, bool)])
    res = I.icp(
        jnp.asarray(model_pad), jnp.asarray(mv_pad), jnp.asarray(scene),
        jnp.asarray(np.ones(scene.shape[0], bool)),
        max_iterations=30, max_corr_dist=0.05, rejection_dist=0.02,
    )
    T = np.asarray(res.transform)
    np.testing.assert_allclose(T, np.eye(4), atol=1e-4)


def test_icp_lm_recovers_pose(rng):
    """LM (IterativeClosestPointNonLinear analog) converges on the same
    point-to-point objective with PCL's strict corr-dist + RANSAC gating."""
    model = make_model(rng)
    R = rot([0.5, 0.2, 1.0], 7.0)
    t = np.array([0.01, 0.006, -0.012], np.float32)
    scene = (model @ R.T + t).astype(np.float32)
    valid = np.ones(model.shape[0], bool)
    res = I.icp_lm(
        jnp.asarray(model), jnp.asarray(valid), jnp.asarray(scene), jnp.asarray(valid),
        max_iterations=60, max_corr_dist=0.05, rejection_dist=0.02,
    )
    T = np.asarray(res.transform)
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(T[:3, :3])))
    terr = np.linalg.norm(T[:3, 3] - t)
    assert ang < 1.0, ang
    assert terr < 0.002, terr


def test_icp_nonlinear_schedule_matches_reference_passes(rng):
    """The 3-pass icpNonLinearPoseRefine schedule (50/0.05 -> 20/0.02 ->
    10/0.005, rgbdDetector.cpp:1546-1597) tightens to sub-mm fitness."""
    model = make_model(rng)
    R = rot([0.1, 0.9, 0.4], 6.0)
    t = np.array([0.008, -0.01, 0.009], np.float32)
    scene = (model @ R.T + t).astype(np.float32)
    valid = np.ones(model.shape[0], bool)
    res = I.icp_nonlinear_schedule(
        jnp.asarray(model), jnp.asarray(valid), jnp.asarray(scene), jnp.asarray(valid)
    )
    T = np.asarray(res.transform)
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(T[:3, :3])))
    assert ang < 0.5, ang
    assert float(res.fitness) < 1e-6


def test_icp_blended_vs_pcl_gate_deviation(rng):
    """Quantify the round-1 deviation: icp()'s blended min(corr^2, 4*rej^2)
    gate vs icp_lm's strict PCL gate (corr AND RANSAC) on a partial-overlap
    cloud with outliers.  Both must land within 1.5 deg of truth and within
    1 deg of each other (the deviation is bounded, not behavior-changing)."""
    model = make_model(rng, n=300)
    R = rot([0.2, 1.0, 0.1], 6.0)
    t = np.array([0.01, 0.004, -0.008], np.float32)
    scene = (model @ R.T + t).astype(np.float32)
    # 15% outliers in the scene.
    n_out = 45
    scene[:n_out] = rng.uniform(-0.2, 0.2, size=(n_out, 3)).astype(np.float32)
    valid = np.ones(model.shape[0], bool)
    a = I.icp(jnp.asarray(model), jnp.asarray(valid), jnp.asarray(scene),
              jnp.asarray(valid), max_iterations=100)
    b = I.icp_lm(jnp.asarray(model), jnp.asarray(valid), jnp.asarray(scene),
                 jnp.asarray(valid), max_iterations=60)
    Ra = np.asarray(a.transform)[:3, :3]
    Rb = np.asarray(b.transform)[:3, :3]
    ang_a = float(geo.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(Ra)))
    ang_b = float(geo.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(Rb)))
    ang_ab = float(geo.rotation_geodesic_deg(jnp.asarray(Ra), jnp.asarray(Rb)))
    assert ang_a < 1.5, ang_a
    assert ang_b < 1.5, ang_b
    assert ang_ab < 1.0, ang_ab


def test_icp_plane_recovers_pose_and_beats_sampling_noise(rng):
    """Point-to-plane ICP recovers a small offset; with DIFFERENT sparse
    samplings of the same surface (the production cloud situation: capped /
    voxelized model and scene sample different pixel phases), it stays
    well under the point-to-point noise floor."""
    lim = np.array([0.05, 0.03, 0.015], np.float32)

    def surface_sample(n, seed):
        r2 = np.random.default_rng(seed)
        pts = r2.uniform(-1, 1, size=(n, 3)).astype(np.float32) * lim
        ax = r2.integers(0, 3, size=n)
        sgn = r2.choice([-1.0, 1.0], size=n)
        pts[np.arange(n), ax] = (sgn * lim[ax]).astype(np.float32)
        nrm = np.zeros((n, 3), np.float32)
        nrm[np.arange(n), ax] = -sgn  # toward origin/camera-ish
        return pts, nrm

    scene, snrm = surface_sample(512, 1)
    model, _ = surface_sample(512, 2)  # different sampling of same surface
    R = rot([0.2, 1.0, -0.3], 2.0)
    t = np.array([0.004, -0.003, 0.002], np.float32)
    model_off = ((model - t) @ R).astype(np.float32)  # inverse transform
    valid = np.ones(512, bool)
    res = I.icp_two_stage_plane(
        jnp.asarray(model_off), jnp.asarray(valid),
        jnp.asarray(scene), jnp.asarray(snrm), jnp.asarray(valid),
    )
    T = np.asarray(res.transform)
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(T[:3, :3])))
    assert ang < 1.0, ang
    np.testing.assert_allclose(T[:3, 3], t, atol=2e-3)
    # ... and beats point-to-point on the identical data (the sampling
    # noise floor that motivated the variant).
    res_pp = I.icp_two_stage(
        jnp.asarray(model_off), jnp.asarray(valid),
        jnp.asarray(scene), jnp.asarray(valid),
    )
    ang_pp = float(geo.rotation_geodesic_deg(
        jnp.asarray(R), jnp.asarray(np.asarray(res_pp.transform)[:3, :3])
    ))
    assert ang <= ang_pp + 0.05, (ang, ang_pp)


def test_icp_plane_zero_normals_are_inert(rng):
    """Points with zero normals (invalid-depth pixels) contribute nothing."""
    model = make_model(rng)
    scene = model.copy()
    nrm = np.zeros_like(scene)
    nrm[: len(nrm) // 2, 2] = -1.0  # only half carry normals
    valid = np.ones(model.shape[0], bool)
    res = I.icp_plane(
        jnp.asarray(model), jnp.asarray(valid), jnp.asarray(scene),
        jnp.asarray(nrm), jnp.asarray(valid), max_iterations=10,
    )
    T = np.asarray(res.transform)
    np.testing.assert_allclose(T, np.eye(4), atol=1e-4)
