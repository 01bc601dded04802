"""STL mesh loading (ASCII and binary), host-side numpy.

The reference consumes STL CAD models through ORK's Renderer3d (via assimp);
both formats must parse: its memoryChip2.stl is ASCII, boxNew.stl is binary
(SURVEY.md section 1 L4).  Output is a flat triangle soup suitable for the
JAX rasterizer in models/renderer.py.  The repository's own object mesh,
data/box_fitted.stl, is a cuboid fitted to the committed bank
(tools/fit_box_mesh.py).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """Triangle soup: vertices (T, 3, 3) float32 (triangle, corner, xyz)."""

    triangles: np.ndarray  # (T, 3, 3)
    normals: np.ndarray  # (T, 3) facet normals (unit, recomputed)

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        pts = self.triangles.reshape(-1, 3)
        return pts.min(axis=0), pts.max(axis=0)

    def centroid(self) -> np.ndarray:
        return self.triangles.reshape(-1, 3).mean(axis=0)

    @classmethod
    def from_triangles(cls, triangles: np.ndarray) -> "Mesh":
        tris = np.asarray(triangles, np.float32).reshape(-1, 3, 3)
        return cls(triangles=tris, normals=_recompute_normals(tris))


def _recompute_normals(tris: np.ndarray) -> np.ndarray:
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    l = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(l, 1e-20)


def _load_ascii(text: str) -> np.ndarray:
    verts = re.findall(
        r"vertex\s+([-+0-9.eE]+)\s+([-+0-9.eE]+)\s+([-+0-9.eE]+)", text
    )
    arr = np.array(verts, dtype=np.float32)
    if arr.size == 0 or arr.shape[0] % 3 != 0:
        raise ValueError("malformed ASCII STL: vertex count not a multiple of 3")
    return arr.reshape(-1, 3, 3)


def _load_binary(data: bytes) -> np.ndarray:
    if len(data) < 84:
        raise ValueError("binary STL too short")
    n_tri = int(np.frombuffer(data[80:84], dtype="<u4")[0])
    expected = 84 + n_tri * 50
    if len(data) < expected:
        raise ValueError(f"binary STL truncated: need {expected} bytes, have {len(data)}")
    rec = np.frombuffer(data[84:expected], dtype=np.uint8).reshape(n_tri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n_tri, 4, 3)
    return floats[:, 1:4, :].astype(np.float32)  # drop the facet normal


def box_triangles(half_extents, center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """(12, 3, 3) float32 triangles of an axis-aligned cuboid, wound
    counter-clockwise seen from outside (outward facet normals)."""
    h = np.asarray(half_extents, np.float64)
    c = np.asarray(center, np.float64)
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                 np.float64) * h + c
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    return v[np.array(faces)].astype(np.float32)


def stl_binary_bytes(triangles: np.ndarray, header: bytes = b"") -> bytes:
    """Binary STL encoding of a (T, 3, 3) triangle soup (facet normals
    recomputed, attribute byte count 0)."""
    tris = np.asarray(triangles, np.float32).reshape(-1, 3, 3)
    rec = np.zeros(tris.shape[0], dtype=[("n", "<f4", (3,)), ("v", "<f4", (3, 3)),
                                         ("attr", "<u2")])
    rec["n"] = _recompute_normals(tris)
    rec["v"] = tris
    head = header[:80].ljust(80, b" ")
    return head + np.uint32(tris.shape[0]).astype("<u4").tobytes() + rec.tobytes()


def stl_ascii_text(triangles: np.ndarray, name: str = "mesh") -> str:
    """ASCII STL encoding of a (T, 3, 3) triangle soup."""
    tris = np.asarray(triangles, np.float32).reshape(-1, 3, 3)
    lines = [f"solid {name}"]
    for t, n in zip(tris, _recompute_normals(tris)):
        lines.append(f"  facet normal {n[0]:e} {n[1]:e} {n[2]:e}")
        lines.append("    outer loop")
        lines.extend(f"      vertex {p[0]:e} {p[1]:e} {p[2]:e}" for p in t)
        lines.append("    endloop")
        lines.append("  endfacet")
    lines.append(f"endsolid {name}")
    return "\n".join(lines) + "\n"


def load_stl(path: str) -> Mesh:
    """Load an STL file, auto-detecting ASCII vs binary."""
    with open(path, "rb") as f:
        data = f.read()
    # ASCII files start with "solid" AND actually contain facet/vertex text.
    is_ascii = False
    if data[:5].lower() == b"solid":
        head = data[:4096].decode("latin-1", errors="replace")
        if "facet" in head or "vertex" in head:
            is_ascii = True
    if is_ascii:
        tris = _load_ascii(data.decode("latin-1", errors="replace"))
    else:
        tris = _load_binary(data)
    return Mesh.from_triangles(tris)
