"""SHOT + Hough-3D local-descriptor pose estimation — the batched JAX analog
of `rgbdDetector::getPoseByLocalDescriptor` (rgbdDetector.cpp:867-1000):

    reference (PCL):                      here (batched JAX):
    NormalEstimationOMP(kSearch=10)       ops.segmentation.estimate_normals
    UniformSampling keypoints             voxel-hash keypoint selection
    SHOTEstimationOMP (SHOT352)           shot_descriptors — one (K, N)
                                          neighbourhood masking + scatter-add
                                          histogram per keypoint batch
    BOARDLocalReferenceFrameEstimation    weighted-covariance EVD frames with
                                          sign disambiguation (the SHOT LRF;
                                          BOARD's border-aware handling is
                                          replaced by the covariance frame —
                                          documented deviation)
    KdTreeFLANN descriptor matching       ONE distance GEMM
                                          (Ks,352)x(352,Km)
    Hough3DGrouping                       per-correspondence vote positions,
                                          voxel-hash vote binning, majority
                                          cell, Kabsch over the winning
                                          cell's correspondences

Everything is fixed-capacity and jit-compatible; descriptor distances and
the correspondence Kabsch are matmuls, the histogram scatter-adds are XLA
scatters over (K, 352) — small and latency-bound.

Deviations from PCL's SHOT (documented): no soft trilinear bin
interpolation; 8 azimuth x 2 elevation x 2 radial = 32 sectors x 11 cosine
bins (same 352-slot layout); descriptors L2-normalized.  These change
descriptor values but not the matching topology on rigid scenes, which is
what the pose path needs (verified by the recover-pose-without-ICP test).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import pointcloud as pcu
from .icp import _kabsch
from .segmentation import estimate_normals

N_AZIMUTH = 8
N_ELEVATION = 2
N_RADIAL = 2
N_COS = 11
SHOT_DIM = N_AZIMUTH * N_ELEVATION * N_RADIAL * N_COS  # 352


def select_keypoints(
    points: jnp.ndarray, valid: jnp.ndarray, leaf: float, k_cap: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform-sampling analog: at most one point per `leaf`-sized voxel,
    first-in-voxel wins; returns (indices (k_cap,), valid (k_cap,))."""
    h = pcu._voxel_hash(points, leaf)
    big = jnp.asarray(jnp.iinfo(h.dtype).max, h.dtype)
    h = jnp.where(valid, h, big)
    order = jnp.argsort(h)
    hs = h[order]
    first = jnp.concatenate([jnp.array([True]), hs[1:] != hs[:-1]])
    first = first & valid[order]
    # Compact first-in-voxel indices to the front of a k_cap buffer.
    pos = jnp.where(first, jnp.cumsum(first) - 1, k_cap)
    out = jnp.zeros((k_cap,), jnp.int32)
    out = out.at[pos].set(order.astype(jnp.int32), mode="drop")
    ok = jnp.arange(k_cap) < jnp.sum(first)
    return out, ok


def local_reference_frames(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    kp_idx: jnp.ndarray,
    radius: float,
) -> jnp.ndarray:
    """(K, 3, 3) local reference frames (rows = x, y, z axes).

    SHOT's LRF: eigenvectors of the radius-weighted covariance of the
    support, weights (radius - d); sign disambiguated toward the weighted
    majority of support points (Tombari's method); y = z x x.
    """
    kp = points[kp_idx]  # (K, 3)
    diff = points[None, :, :] - kp[:, None, :]  # (K, N, 3)
    d = jnp.linalg.norm(diff, axis=-1)
    w = jnp.maximum(radius - d, 0.0) * valid[None, :]
    wsum = jnp.maximum(jnp.sum(w, axis=1), 1e-9)
    cov = jnp.einsum("kn,kni,knj->kij", w, diff, diff) / wsum[:, None, None]
    _, evecs = jnp.linalg.eigh(cov)  # ascending eigenvalues
    z = evecs[..., 0]
    x = evecs[..., 2]
    sx = jnp.sum(w * jnp.einsum("kni,ki->kn", diff, x), axis=1)
    x = jnp.where((sx < 0)[:, None], -x, x)
    sz = jnp.sum(w * jnp.einsum("kni,ki->kn", diff, z), axis=1)
    z = jnp.where((sz < 0)[:, None], -z, z)
    y = jnp.cross(z, x)
    return jnp.stack([x, y, z], axis=1)  # rows = axes


def shot_descriptors(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    normals: jnp.ndarray,
    kp_idx: jnp.ndarray,
    kp_valid: jnp.ndarray,
    lrf: jnp.ndarray,
    radius: float,
) -> jnp.ndarray:
    """(K, 352) SHOT descriptors, L2-normalized.

    Each support point lands in one of 32 spatial sectors of the keypoint's
    LRF-aligned ball (8 azimuth x 2 elevation x 2 radial) and an 11-bin
    histogram over |cos| of the angle between its normal and the keypoint's
    LRF z axis (SHOT proper uses the signed cosine; kNN-PCA normal SIGNS
    depend on the viewpoint and are not rigid-invariant, so the absolute
    value keeps descriptors stable across camera frames — documented
    deviation).
    """
    K = kp_idx.shape[0]
    kp = points[kp_idx]
    diff = points[None, :, :] - kp[:, None, :]  # (K, N, 3)
    local = jnp.einsum("kij,knj->kni", lrf, diff)
    d = jnp.linalg.norm(local, axis=-1)
    inside = (d < radius) & (d > 1e-9) & valid[None, :] & kp_valid[:, None]

    az = jnp.arctan2(local[..., 1], local[..., 0])  # (-pi, pi]
    az_bin = jnp.clip(
        jnp.floor((az + jnp.pi) * (N_AZIMUTH / (2 * jnp.pi))).astype(jnp.int32),
        0, N_AZIMUTH - 1,
    )
    el_bin = (local[..., 2] > 0).astype(jnp.int32)
    rad_bin = (d > radius * 0.5).astype(jnp.int32)
    z_axis = lrf[:, 2, :]  # (K, 3)
    cosang = jnp.abs(jnp.clip(jnp.einsum("ki,ni->kn", z_axis, normals), -1.0, 1.0))
    cos_bin = jnp.clip(
        jnp.floor(cosang * N_COS).astype(jnp.int32), 0, N_COS - 1
    )
    sector = (az_bin * N_ELEVATION + el_bin) * N_RADIAL + rad_bin
    didx = sector * N_COS + cos_bin  # (K, N)

    rows = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[:, None], didx.shape)
    desc = jnp.zeros((K, SHOT_DIM), jnp.float32)
    desc = desc.at[rows, didx].add(inside.astype(jnp.float32))
    norm = jnp.maximum(jnp.linalg.norm(desc, axis=1, keepdims=True), 1e-9)
    return desc / norm


def match_descriptors(
    desc_scene: jnp.ndarray,
    scene_valid: jnp.ndarray,
    desc_model: jnp.ndarray,
    model_valid: jnp.ndarray,
    max_sq_dist: float = 0.25,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest-model-descriptor per scene keypoint via ONE distance GEMM —
    the KdTreeFLANN nearestKSearch(1) + `< 0.25` gate of the reference
    (rgbdDetector.cpp:938-955).  Returns (model index (Ks,), valid)."""
    d2 = (
        jnp.sum(desc_scene**2, axis=1)[:, None]
        - 2.0 * desc_scene @ desc_model.T
        + jnp.sum(desc_model**2, axis=1)[None, :]
    )
    d2 = jnp.where(model_valid[None, :], d2, jnp.inf)
    j = jnp.argmin(d2, axis=1)
    best = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
    ok = scene_valid & (best < max_sq_dist) & jnp.isfinite(best)
    return j.astype(jnp.int32), ok


class LocalDescriptorPose(NamedTuple):
    pose: jnp.ndarray  # (4, 4) model -> scene rigid transform
    votes: jnp.ndarray  # () int32 — winning Hough cell population
    n_correspondences: jnp.ndarray  # () int32
    valid: jnp.ndarray  # () bool


def hough_pose(
    scene_kp: jnp.ndarray,
    model_kp: jnp.ndarray,
    scene_lrf: jnp.ndarray,
    model_lrf: jnp.ndarray,
    model_ref: jnp.ndarray,
    corr_model: jnp.ndarray,
    corr_valid: jnp.ndarray,
    bin_size: float,
    min_votes: int,
) -> LocalDescriptorPose:
    """Hough3DGrouping analog: every correspondence casts a vote for the
    model reference point's position in scene space through its LRF pair;
    votes bin into a `bin_size` voxel grid; the winning cell's
    correspondences give the pose by weighted Kabsch."""
    m = corr_model  # (Ks,) model keypoint per scene keypoint
    # Model-frame offset keypoint -> reference point, expressed in the
    # keypoint's LRF, then re-expressed through the matched scene LRF.
    off_local = jnp.einsum(
        "kij,kj->ki", model_lrf[m], model_ref[None, :] - model_kp[m]
    )
    votes = scene_kp + jnp.einsum("kji,kj->ki", scene_lrf, off_local)

    h = pcu._voxel_hash(votes, bin_size)
    big = jnp.asarray(jnp.iinfo(h.dtype).max, h.dtype)
    h = jnp.where(corr_valid, h, big)
    # Majority cell: compare all pairs of hashes (Ks is small).
    same = (h[:, None] == h[None, :]) & corr_valid[None, :] & corr_valid[:, None]
    pop = jnp.sum(same, axis=1)
    winner = jnp.argmax(pop)
    in_cell = same[winner]
    n_votes = pop[winner]

    w = in_cell.astype(jnp.float32)
    T = _kabsch(model_kp[m], scene_kp, w)
    return LocalDescriptorPose(
        pose=T,
        votes=n_votes.astype(jnp.int32),
        n_correspondences=jnp.sum(corr_valid).astype(jnp.int32),
        valid=n_votes >= min_votes,
    )


@partial(
    jax.jit,
    static_argnames=("k_cap", "normal_k", "min_votes"),
)
def get_pose_by_local_descriptor(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_valid: jnp.ndarray,
    keypoint_leaf: float = 0.01,
    descr_radius: float = 0.02,
    lrf_radius: float = 0.015,
    bin_size: float = 0.01,
    max_sq_dist: float = 0.25,
    k_cap: int = 128,
    normal_k: int = 10,
    min_votes: int = 5,
) -> LocalDescriptorPose:
    """The full getPoseByLocalDescriptor chain (rgbdDetector.cpp:867-1000):
    normals -> keypoints -> LRFs -> SHOT -> descriptor matching -> Hough
    voting -> pose.  Recovers a 6D pose WITHOUT ICP."""
    mn, _ = estimate_normals(model_pts, model_valid, k=normal_k)
    sn, _ = estimate_normals(scene_pts, scene_valid, k=normal_k)

    mki, mkv = select_keypoints(model_pts, model_valid, keypoint_leaf, k_cap)
    ski, skv = select_keypoints(scene_pts, scene_valid, keypoint_leaf, k_cap)

    mlrf = local_reference_frames(model_pts, model_valid, mki, lrf_radius)
    slrf = local_reference_frames(scene_pts, scene_valid, ski, lrf_radius)

    mdesc = shot_descriptors(model_pts, model_valid, mn, mki, mkv, mlrf, descr_radius)
    sdesc = shot_descriptors(scene_pts, scene_valid, sn, ski, skv, slrf, descr_radius)

    corr, cok = match_descriptors(sdesc, skv, mdesc, mkv, max_sq_dist)

    model_ref = pcu.masked_centroid(model_pts, model_valid)
    return hough_pose(
        scene_pts[ski], model_pts[mki], slrf, mlrf, model_ref,
        corr, cok, bin_size, min_votes,
    )
