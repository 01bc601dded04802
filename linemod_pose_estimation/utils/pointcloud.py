"""Point-cloud primitives, static-shape style: fixed capacity + validity
masks.

Replaces the PCL utility layer the reference leans on (SURVEY.md section 2.2
E3): depth<->cloud conversion (cv::depthTo3d / the nodes' pc2depth),
masked/ROI extraction (rgbdDetector::getPointCloudIndices +
extractPointsByIndices, rgbdDetector.cpp:1414-1455, 1604-1626), centroids,
voxel-grid downsampling, statistical outlier removal and brute-force
nearest-neighbour — all as static-shape JAX ops so the whole cascade jits.

Convention: a cloud is `(points (N,3) float32, valid (N,) bool)`.  Invalid
slots hold a large sentinel coordinate so they never win NN queries.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

SENTINEL = 1e6  # coordinate for invalid/padded points


def pad_cloud(points: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Replace invalid points with the far-away sentinel."""
    return jnp.where(valid[:, None], points, SENTINEL)


# ---------------------------------------------------------------------------
# Depth <-> cloud (ref: cv::depthTo3d at rgbdDetector.cpp:797; pc2depth at
# service.cpp:837-858 / carmine:829-836)
# ---------------------------------------------------------------------------


def depth_to_cloud(depth_m: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Depth in meters (H, W) -> organized cloud (H, W, 3); 0-depth -> NaN."""
    H, W = depth_m.shape
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    z = depth_m
    x = (u - K[0, 2]) * z / K[0, 0]
    y = (v - K[1, 2]) * z / K[1, 1]
    cloud = jnp.stack([x, y, z], axis=-1)
    return jnp.where(depth_m[..., None] > 0, cloud, jnp.nan)


def cloud_to_depth_mm(cloud: jnp.ndarray) -> jnp.ndarray:
    """Organized cloud (H, W, 3) -> uint16 depth in millimeters.

    Matches the nodes' pc2depth: z*1000 as 16UC1, NaN -> 0
    (service.cpp:837-858).
    """
    z = cloud[..., 2]
    z = jnp.where(jnp.isnan(z), 0.0, z)
    return jnp.clip(z * 1000.0, 0, 65535).astype(jnp.uint16)


def extract_rect_points(
    cloud: jnp.ndarray,
    rect_xywh: jnp.ndarray,
    cap: int,
    mask: jnp.ndarray | None = None,
    bias_x: int = 0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather organized-cloud points inside a (possibly masked) ROI.

    Mirrors getPointCloudIndices(+mask overload) + extractPointsByIndices
    (rgbdDetector.cpp:1414-1455, 1604-1626): ROI pixels are mapped to
    organized-cloud indices with a horizontal `bias_x` (Ensenso 752-wide
    cloud vs 640-wide cropped image, service.cpp:212).

    Returns (points (cap, 3), valid (cap,)).  `rect_xywh` is traced (dynamic
    position), `cap` static.  If `mask` (H, W) is given, only mask>0 pixels
    inside the rect are taken.
    """
    H, W = cloud.shape[:2]
    x0, y0, w, h = rect_xywh[0], rect_xywh[1], rect_xywh[2], rect_xywh[3]
    vv = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    uu = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (uu >= x0 + bias_x) & (uu < x0 + w + bias_x) & (vv >= y0) & (vv < y0 + h)
    if mask is not None:
        # mask is indexed in image coords (no bias).
        shifted = jnp.roll(mask > 0, bias_x, axis=1) if bias_x else (mask > 0)
        inside = inside & shifted
    finite = jnp.all(jnp.isfinite(cloud), axis=-1)
    sel = inside & finite
    flat_sel = sel.reshape(-1)
    flat_cloud = cloud.reshape(-1, 3)
    # Stable compaction: indices of selected pixels first, padded with N.
    order = jnp.argsort(~flat_sel, stable=True)[:cap]
    valid = flat_sel[order]
    pts = jnp.where(valid[:, None], flat_cloud[order], SENTINEL)
    return pts.astype(jnp.float32), valid


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


def masked_centroid(points: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    n = jnp.maximum(jnp.sum(valid), 1)
    return jnp.sum(jnp.where(valid[:, None], points, 0.0), axis=0) / n


def pairwise_sq_dists(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(N,3) x (M,3) -> (N,M) squared distances via a matmul.

    Numerics are load-bearing: the |a|^2 - 2ab + |b|^2 expansion cancels
    catastrophically for mm-scale distances at m-scale coordinates (terms
    ~0.2 m^2, true distances ~1e-6 m^2), and a reduced-precision matmul
    (bf16 passes, or TF32 on a GPU) makes the cross term noisy enough to
    turn ICP nearest-neighbour assignment into noise (a
    0.2-degree-correct seed pose walked to ~90 degrees).  Two defences: center both clouds by a shared offset so
    the cancelling magnitudes drop ~100x, and run the cross term at
    HIGHEST (f32-equivalent) precision."""
    real = (jnp.abs(b) < SENTINEL * 0.5).all(axis=-1, keepdims=True)
    c = jnp.mean(b, axis=0, where=real)
    c = jnp.where(jnp.isfinite(c), c, 0.0)
    ac, bc = a - c[None, :], b - c[None, :]
    a2 = jnp.sum(ac * ac, axis=-1, keepdims=True)
    b2 = jnp.sum(bc * bc, axis=-1, keepdims=True)
    cross = jax.lax.dot(ac, bc.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(a2 - 2.0 * cross + b2.T, 0.0)


def nearest_point(points: jnp.ndarray, valid: jnp.ndarray, query: jnp.ndarray) -> jnp.ndarray:
    """Closest valid point to `query` (3,) — PCL KdTree nearestKSearch(K=1)
    as used by getPositionBySurfaceCentroid (rgbdDetector.cpp:1070-1086)."""
    d = jnp.sum((points - query) ** 2, axis=-1)
    d = jnp.where(valid, d, jnp.inf)
    return points[jnp.argmin(d)]


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------


def _voxel_hash(points: jnp.ndarray, leaf: float) -> jnp.ndarray:
    """(N, 3) -> int32 voxel id: 10 bits per axis (coords clipped to +-512
    voxels around the origin — ample for tabletop/bin-picking scenes at
    millimeter leafs; JAX x64 is off, so the hash must fit int32)."""
    ids3 = jnp.clip(jnp.floor(points / leaf).astype(jnp.int32), -512, 511) + 512
    return (ids3[:, 0] << 20) | (ids3[:, 1] << 10) | ids3[:, 2]


def statistical_outlier_removal(
    points: jnp.ndarray, valid: jnp.ndarray, mean_k: int = 50, std_mul: float = 1.0,
    exact: bool = False,
) -> jnp.ndarray:
    """PCL StatisticalOutlierRemoval semantics (rgbdDetector.cpp:1437-1448):

    per-point mean distance to its `mean_k` nearest neighbours; drop points
    whose mean distance exceeds global mean + std_mul * stddev.  Returns the
    updated validity mask.

    `exact=True` uses exact lax.top_k for the kNN (PCL-equivalent
    semantics); the default approx_min_k is exact on CPU and GPU, and
    elsewhere may have ~0.95 recall of the true neighbours, which biases
    mean-kNN distances slightly upward and can flip borderline points on
    parity-sensitive paths.
    """
    pts = pad_cloud(points, valid)
    d2 = pairwise_sq_dists(pts, pts)
    n = points.shape[0]
    d2 = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, d2)
    d2 = jnp.where(valid[None, :], d2, jnp.inf)
    k = min(mean_k, n - 1)
    # approx_min_k: a partial reduction where the backend has one (SOR is
    # a statistical gate — the mean-of-kNN barely moves).
    if exact:
        neg_topk = jax.lax.top_k(-d2, k)[0]
    else:
        neg_topk = jax.lax.approx_max_k(-d2, k)[0]
    dists = jnp.sqrt(jnp.maximum(-neg_topk, 0.0))
    # Only average over neighbours that exist (finite).
    finite = jnp.isfinite(dists)
    cnt = jnp.maximum(jnp.sum(finite, axis=1), 1)
    mean_d = jnp.sum(jnp.where(finite, dists, 0.0), axis=1) / cnt
    nv = jnp.maximum(jnp.sum(valid), 1)
    mu = jnp.sum(jnp.where(valid, mean_d, 0.0)) / nv
    var = jnp.sum(jnp.where(valid, (mean_d - mu) ** 2, 0.0)) / nv
    thresh = mu + std_mul * jnp.sqrt(var)
    return valid & (mean_d <= thresh)


def voxel_grid_filter(
    points: jnp.ndarray, valid: jnp.ndarray, leaf: float, cap: int,
    aux: jnp.ndarray | None = None,
):
    """PCL VoxelGrid semantics (rgbdDetector.cpp:1450-1455): one output point
    per occupied voxel, at the centroid of the voxel's members.

    Sort-free static-shape algorithm: the (N, N) voxel-id equality matrix
    is one fused pass and the per-voxel centroid sums are one matmul
    (eq @ points).  First-occurrence rows are the voxel representatives,
    compacted to `cap` with a cumsum + scatter.

    `aux` (N, 3) rides along with the same per-voxel averaging (e.g. point
    normals for point-to-plane ICP); returns (pts, valid, aux_out) then.
    """
    N = points.shape[0]
    vid = _voxel_hash(jnp.where(valid[:, None], points, SENTINEL), leaf)
    eq = (vid[:, None] == vid[None, :]) & valid[:, None] & valid[None, :]
    ii = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
    first = valid & ~jnp.any(eq & (jj < ii), axis=1)  # no earlier member
    cnts = jnp.sum(eq, axis=1).astype(jnp.float32)
    eqf = eq.astype(jnp.float32)
    sums = eqf @ jnp.where(valid[:, None], points, 0.0)
    centroids = sums / jnp.maximum(cnts, 1.0)[:, None]

    pos = jnp.where(first, jnp.cumsum(first) - 1, cap)
    out_pts = jnp.full((cap, 3), SENTINEL, jnp.float32)
    out_pts = out_pts.at[pos].set(centroids.astype(jnp.float32), mode="drop")
    ok = jnp.arange(cap) < jnp.sum(first)
    out = (jnp.where(ok[:, None], out_pts, SENTINEL), ok)
    if aux is None:
        return out
    asums = eqf @ jnp.where(valid[:, None], aux, 0.0)
    a_cent = asums / jnp.maximum(cnts, 1.0)[:, None]
    out_aux = jnp.zeros((cap, 3), jnp.float32)
    out_aux = out_aux.at[pos].set(a_cent.astype(jnp.float32), mode="drop")
    return out + (jnp.where(ok[:, None], out_aux, 0.0),)


def voxel_occupancy_rate(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_valid: jnp.ndarray,
    resolution: float,
) -> jnp.ndarray:
    """Fraction of model points whose voxel is occupied by the scene.

    The reference's octree hypothesis verification
    (rgbdDetector::hypothesisVerification, rgbdDetector.cpp:1457-1506) at
    `octree_res`: here a sorted voxel-hash membership test.
    """

    # Sort-free membership: an (M, S) voxel-id equality matrix is one fused
    # pass.
    sid = jnp.where(
        scene_valid, _voxel_hash(pad_cloud(scene_pts, scene_valid), resolution),
        jnp.int32(2**31 - 1),
    )
    mid = jnp.where(
        model_valid, _voxel_hash(pad_cloud(model_pts, model_valid), resolution),
        jnp.int32(2**31 - 2),
    )
    hit = jnp.any(mid[:, None] == sid[None, :], axis=1) & model_valid
    n = jnp.maximum(jnp.sum(model_valid), 1)
    return jnp.sum(hit) / n
