"""C5 depth/normal verification scoring."""

import jax.numpy as jnp
import numpy as np

from linemod_pose_estimation.ops import verification as V
from linemod_pose_estimation.utils.geometry import make_K


def make_scene(depth_base=500.0, tilt=0.0):
    """A 64x64 planar depth patch inside a 96x128 frame (mm)."""
    d = np.zeros((96, 128), np.float32)
    yy, xx = np.mgrid[0:64, 0:64]
    d[16:80, 32:96] = depth_base + tilt * xx
    return d


def test_depth_normals_flat_plane():
    K = make_K(100.0, 100.0, 64, 48)
    d = make_scene()
    n = np.asarray(V.depth_normals(jnp.asarray(d), K))
    inner = n[30:70, 40:90]
    # Flat plane facing the camera: normal ~ (0, 0, -1).
    np.testing.assert_allclose(np.abs(inner[..., 2]).mean(), 1.0, atol=0.02)
    assert (inner[..., 2] < 0).mean() > 0.95


def test_depth_normal_score_perfect_match():
    K = make_K(100.0, 100.0, 64, 48)
    scene = make_scene()
    sn = V.depth_normals(jnp.asarray(scene), K)
    # Template = the same patch rendered "centered" at its own rect.
    tmpl_depth = scene.copy()
    tmpl_mask = (scene > 0).astype(np.uint8) * 255
    tn = V.depth_normals(jnp.asarray(tmpl_depth), K)
    rect = jnp.array([32, 16, 64, 64])
    score, dd, nd = V.depth_normal_score(
        jnp.asarray(scene), sn, jnp.asarray(tmpl_depth), jnp.asarray(tmpl_mask), tn,
        rect, jnp.int32(32), jnp.int32(16), E=64,
    )
    assert float(dd) < 1e-5
    assert float(nd) < 0.05
    assert float(score) > 0.95


def test_depth_normal_score_detects_mismatch():
    K = make_K(100.0, 100.0, 64, 48)
    scene = make_scene(depth_base=500.0)
    sn = V.depth_normals(jnp.asarray(scene), K)
    # Template 100 mm closer and tilted: both diffs grow, score drops.
    tmpl_depth = make_scene(depth_base=400.0, tilt=3.0)
    tmpl_mask = (tmpl_depth > 0).astype(np.uint8) * 255
    tn = V.depth_normals(jnp.asarray(tmpl_depth), K)
    rect = jnp.array([32, 16, 64, 64])
    score, dd, nd = V.depth_normal_score(
        jnp.asarray(scene), sn, jnp.asarray(tmpl_depth), jnp.asarray(tmpl_mask), tn,
        rect, jnp.int32(32), jnp.int32(16), E=64,
    )
    assert float(dd) > 0.04  # ~48mm mean diff in meters for this fixture
    assert float(nd) > 0.1
    assert float(score) < 0.9
