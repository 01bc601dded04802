"""STL parser on generated ASCII and binary bytes, and the committed mesh."""

import numpy as np

from linemod_pose_estimation.utils import stl

from conftest import BOX_STL


def _chip_triangles():
    # A thin chip-sized cuboid, off-centre, as an arbitrary test mesh.
    return stl.box_triangles((0.015, 0.01, 0.002), center=(0.001, -0.002, 0.0))


def test_ascii_stl_memory_chip(tmp_path):
    tris = _chip_triangles()
    p = tmp_path / "chip.stl"
    p.write_text(stl.stl_ascii_text(tris, name="chip"))
    mesh = stl.load_stl(str(p))
    assert mesh.num_triangles == 12
    np.testing.assert_allclose(mesh.triangles, tris, atol=1e-6)
    lo, hi = mesh.bounds()
    np.testing.assert_allclose(hi - lo, [0.03, 0.02, 0.004], atol=1e-6)
    n = np.linalg.norm(mesh.normals, axis=1)
    np.testing.assert_allclose(n, 1.0, atol=1e-4)


def test_binary_stl_box():
    """The committed fitted cuboid: binary, 12 triangles, outward normals."""
    with open(BOX_STL, "rb") as f:
        data = f.read()
    mesh = stl.load_stl(BOX_STL)
    assert mesh.num_triangles == (len(data) - 84) // 50 == 12
    lo, hi = mesh.bounds()
    assert np.all(np.isfinite(mesh.triangles))
    assert np.all(hi - lo < 1.0) and np.all(hi - lo > 0.01)
    out = np.sum(mesh.normals * (mesh.triangles.mean(1) - mesh.centroid()), 1)
    assert np.all(out > 0)


def test_binary_stl_cpu(tmp_path):
    """Binary bytes whose 80-byte header starts with "solid" (legal, and a
    classic ASCII-detection trap) still parse as binary."""
    tris = _chip_triangles()
    data = stl.stl_binary_bytes(tris, header=b"solid but binary")
    assert len(data) == 84 + 50 * 12
    p = tmp_path / "cpu_binary.stl"
    p.write_bytes(data)
    mesh = stl.load_stl(str(p))
    assert mesh.num_triangles == 12
    np.testing.assert_allclose(mesh.triangles, tris)
