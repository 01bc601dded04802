"""Fit the repository's object mesh: a cuboid whose projection reproduces
the committed bank's per-view bounding boxes.

The trained banks (data/boxNew_*_params.yml.gz) record, for each of their
2652 views, the object->camera pose (R, T), the intrinsics K and the tight
mask bounding box Rect of the rendered object.  A cuboid with half-extents
h and centre c (object frame) projects its 8 corners at each view; the
least-squares fit (scipy) matches the corners' projected min/max to every
Rect.  The mesh stands in for the original CAD model, which the repository
does not carry; the fit residual says how far it is from the real outline.

    python tools/fit_box_mesh.py [params.yml.gz] [out.stl]

Prints one JSON line with the fitted extents and the residual in pixels,
and writes a 12-triangle binary STL (default data/box_fitted.stl).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
from scipy.optimize import least_squares

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from linemod_pose_estimation.models.templates import TemplateBank  # noqa: E402
from linemod_pose_estimation.utils.stl import box_triangles, stl_binary_bytes  # noqa: E402

_SIGNS = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                  np.float64)


def projected_boxes(theta: np.ndarray, R: np.ndarray, T: np.ndarray,
                    K: np.ndarray) -> np.ndarray:
    """(N, 4) projected corner bounds (u_min, v_min, u_max, v_max) of the
    cuboid theta = (hx, hy, hz, cx, cy, cz) at every view (X_cam =
    R (X + T), the bank's camera convention)."""
    corners = _SIGNS * theta[:3] + theta[3:]  # (8, 3)
    X = np.einsum("nij,nkj->nki", R, corners[None] + T[:, None, :])  # (N, 8, 3)
    u = K[:, 0, 0, None] * X[..., 0] / X[..., 2] + K[:, 0, 2, None]
    v = K[:, 1, 1, None] * X[..., 1] / X[..., 2] + K[:, 1, 2, None]
    return np.stack([u.min(1), v.min(1), u.max(1), v.max(1)], axis=1)


def fit_box(meta) -> tuple[np.ndarray, np.ndarray]:
    """Least-squares cuboid fit; returns (theta, per-view residuals (N, 4)
    in px)."""
    R = np.asarray(meta.R, np.float64)
    T = np.asarray(meta.T, np.float64)
    K = np.asarray(meta.K, np.float64)
    rect = np.asarray(meta.Rect, np.float64)
    target = np.stack([rect[:, 0], rect[:, 1], rect[:, 0] + rect[:, 2],
                       rect[:, 1] + rect[:, 3]], axis=1)

    def resid(theta):
        return (projected_boxes(theta, R, T, K) - target).ravel()

    x0 = np.array([0.05, 0.05, 0.05, 0.0, 0.0, 0.0])
    lb = np.array([1e-3, 1e-3, 1e-3, -0.2, -0.2, -0.2])
    ub = np.array([0.5, 0.5, 0.5, 0.2, 0.2, 0.2])
    sol = least_squares(resid, x0, bounds=(lb, ub), x_scale="jac")
    return sol.x, resid(sol.x).reshape(-1, 4)


def main() -> None:
    params = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "data", "boxNew_rgbd_params.yml.gz")
    out = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        REPO, "data", "box_fitted.stl")
    meta, _ = TemplateBank.read_params_yaml(params)
    theta, res = fit_box(meta)
    with open(out, "wb") as f:
        f.write(stl_binary_bytes(box_triangles(theta[:3], theta[3:]),
                                 b"cuboid fitted to bank Rects"))
    print(json.dumps({
        "views": int(res.shape[0]),
        "half_extents_m": [float(v) for v in theta[:3]],
        "center_m": [float(v) for v in theta[3:]],
        "rms_px": float(np.sqrt(np.mean(res ** 2))),
        "mean_abs_px": float(np.mean(np.abs(res))),
        "max_abs_px": float(np.max(np.abs(res))),
        "out": os.path.relpath(out, REPO),
    }))


if __name__ == "__main__":
    main()
