"""The post-match detection cascade, fixed-capacity JAX end to end.

Re-creates the reference's `detect_cb` stage order (SURVEY.md section 3.2,
service.cpp:274-599) as static-shape device stages:

  matches ──rcd_voting (C2)──► vote cells (y/step, x/step, depth-bin)
          ──cluster_filter (C3, drop <= thresh)
          ──cluster_scoring (C4, mean similarity)
          ──nonMaximaSuppressionUsingIOU (C7, averaged bboxes, IoU > 0.4)
          ──getRoughPoseByClustering (C8): greedy orientation clustering,
             quaternion/translation averaging, re-render at the averaged
             pose, model/scene cloud extraction, SOR + voxel filters,
             surface-centroid position pairing (C9 active strategy)
          ──icpPoseRefine (C10, coarse+fine)
          ──hypothesisVerification (C11, voxel occupancy)
          ──pose canonicalization (C22)

Variable-size sets (vote cells, cluster members, clouds) are capacity-padded
with validity masks so the whole cascade jits and vmaps; sort+segment ops
replace the reference's std::map grouping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.icp import icp_nonlinear_schedule, icp_two_stage, icp_two_stage_plane
from ..ops.match import Matches
from ..utils import geometry as geo
from ..utils import pointcloud as pcu
from .renderer import render as render_fn


@dataclass
class CascadeParams:
    """Knobs of the reference cascade: argv/launch layer (SURVEY.md section 5
    config) + hard-coded ctor constants."""

    clustering_step: int = 20  # vote_row_col_step (launch default)
    cluster_filter_thresh: int = 2  # drop cells with <= thresh matches (service.cpp:401)
    iou_threshold: float = 0.4  # rgbdDetector.cpp:512
    orientation_clustering_th: float = 10.0  # degrees (launch default)
    # ICP (launch args 5-8 + hard-coded fine pass, rgbdDetector.cpp:1349-1366)
    icp_max_iter: int = 150
    icp_max_corr_dist: float = 0.05
    icp_tr_epsilon: float = 1e-5
    icp_ransac_thresh: float = 0.02
    icp_fine_iter: int = 20
    icp_fine_corr_dist: float = 0.01
    icp_fine_ransac: float = 0.01
    # "two_stage" = icpPoseRefine (coarse+fine Kabsch); "nonlinear" =
    # icpNonLinearPoseRefine's 3-pass Levenberg-Marquardt schedule
    # (rgbdDetector.cpp:1508-1600)
    icp_variant: str = "two_stage"
    # Cloud conditioning (hard-coded, rgbdDetector.cpp:842-850)
    sor_mean_k: int = 50
    sor_std_mul: float = 1.0
    voxel_leaf: float = 0.002
    # Hypothesis verification (carmine:895-909)
    hv_resolution: float = 0.004
    hv_threshold: float = 0.30
    enable_hv: bool = False
    # Pose canonicalization: "x_front" (service.cpp:562-583),
    # "z_down" (carmine:487-495) or "none"
    canonicalize: str = "x_front"
    # C9 position strategy: "surface_centroid" (active in the reference,
    # rgbdDetector.cpp:855), "roi_center" (cpp:1027-1060),
    # "distance_offset" (cpp:984-1025) or "local_descriptor" (SHOT + Hough
    # grouping, cpp:867-1000 — the dormant full-pose path)
    position_strategy: str = "surface_centroid"
    distance_offset_uses_hole: bool = False  # is_center_hole handling
    # local_descriptor knobs (ops/local_descriptor.py)
    ld_keypoint_leaf: float = 0.008
    ld_descr_radius: float = 0.02
    ld_lrf_radius: float = 0.015
    ld_bin_size: float = 0.01
    ld_keypoint_cap: int = 96
    ld_min_votes: int = 5
    # Ensenso geometry (service.cpp:212, 324-326)
    bias_x: int = 0
    # Rough-pose re-render viewport: the re-rendered object sits at the
    # principal point, so rasterizing a centered VP x VP window (principal
    # point moved to VP/2) produces the identical model cloud and mask at
    # ~(W*H)/(VP^2) less rasterizer work — the reference's renderDepthOnly
    # is likewise rect-local (rgbdDetector.cpp:712-721).  0 = full frame.
    render_viewport: int = 256
    # Template-refinement rounds (carmine templateRefinement, carmine:
    # 555-652): after the ICP stages, re-render the model at the REFINED
    # pose — replacing the orientation-cluster-average geometry with the
    # pose-consistent view — and re-run ICP against the same scene points.
    # Each round removes the residual between the averaged template
    # rotation (bank angle_step quantization) and the actual object pose.
    refine_rounds: int = 0
    refine_icp_iter: int = 30
    # In-plane rotation repair for RANK-DEFICIENT hypotheses
    # (point_to_plane only): when one face dominates the visible scene
    # surface, the point-to-plane normal equations constrain rotation
    # about that face's normal weakly or not at all — a view whose best
    # template sits one view-sphere neighbour over keeps a 1-3 deg
    # in-plane offset through ICP (the ACCURACY.json deg_err max tail).
    # The repair recovers the offset in closed form from each cloud's
    # in-plane RECTANGLE ORIENTATION (full +-45 deg min-area-bbox sweep
    # of the dominant-plane points, about the MODE scene normal found by
    # mean-shift) and rotates the model by the orientation difference —
    # plane distances are invariant, so ICP's converged depth alignment
    # is preserved.  Applied only when the fraction of scene normals
    # within ~25 deg of the mode exceeds inplane_dominance (measured
    # 0.95 on the single-face tail view, 0.84 on a two-face one), both
    # clouds' bbox-area sweeps are >5% modulated (a near-circular
    # projection has no orientation), their oriented-bbox dims agree
    # within 10%, and the angle is in [0.25 deg, inplane_sweep_deg].
    # inplane_sweep=False disables (the sweep grids are fixed at
    # 181 coarse x 21 fine — there is no density knob).
    # (See inplane_sweep_fix for why NN-scored sweeps cannot see this
    # offset at cascade sampling density.)
    inplane_sweep_deg: float = 6.0
    inplane_sweep: bool = True
    inplane_dominance: float = 0.7
    # Dilate the transplanted scene mask before extracting scene points.
    # The rendered mask lands at the MATCH position, which carries the
    # T0-1 px plateau of the coarse level; undilated, a 1-px offset clips
    # the object boundary asymmetrically and biases ICP rotation by
    # ~px/extent (~0.4 deg for the reference box).  A few px of dilation
    # keeps the full outline; SOR + the ICP rejection distance drop any
    # off-object points the dilation admits.
    scene_mask_dilate_px: int = 2
    # Orientation hypotheses per position cluster (C8 generalization):
    # 1 = reference behavior (largest orientation group wins).  2 = also
    # pose/ICP/verify the runner-up orientation group and keep whichever
    # verifies better — the cure for visually near-symmetric objects where
    # the symmetry partner out-votes the true orientation (a 180-degree
    # flip of an untextured cuboid).  Costs one extra render+ICP per
    # cluster when enabled.
    orientation_hypotheses: int = 1
    # Defer IoU NMS until AFTER pose estimation and rank overlapping
    # clusters by verification (occupancy) instead of match score: a
    # symmetric flip can out-SCORE the true orientation but cannot
    # out-verify it.
    nms_after_pose: bool = False
    # Static capacities
    max_matches: int = 512
    max_cells: int = 64
    members_cap: int = 64
    max_seeds: int = 16
    max_clusters: int = 4
    model_cap: int = 1024
    scene_cap: int = 1024


class ClusterSet(NamedTuple):
    """Vote cells after grouping (analog of map<vector<int>, vector<Match>>)."""

    score: jnp.ndarray  # (C,) mean similarity
    count: jnp.ndarray  # (C,)
    bbox: jnp.ndarray  # (C, 4) float32 averaged (x, y, w, h)
    valid: jnp.ndarray  # (C,)
    member_idx: jnp.ndarray  # (C, M) indices into the match arrays
    member_valid: jnp.ndarray  # (C, M)


@partial(jax.jit, static_argnames=("step", "max_cells", "members_cap", "filter_thresh"))
def cluster_matches(
    matches: Matches,
    ori_dists: jnp.ndarray,
    rects: jnp.ndarray,
    radius_min: float,
    radius_step: float,
    step: int,
    filter_thresh: int,
    max_cells: int,
    members_cap: int,
) -> ClusterSet:
    """C2 rcd_voting + C3 cluster_filter + C4 cluster_scoring + the averaged
    bbox of C7 — grouping by (y/step, x/step, depth-bin) via sort+segments."""
    K = matches.template_id.shape[0]
    depth = ori_dists[matches.template_id]
    d_idx = jnp.floor((depth - radius_min) / radius_step).astype(jnp.int32)
    hy = matches.y // step
    hx = matches.x // step
    # Pack the 3-D vote index into one int32 id (d_idx small, hy/hx < 2^10).
    cell = ((hy & 1023) << 20) | ((hx & 1023) << 10) | ((d_idx + 32) & 1023)
    BIG = jnp.int32(2**31 - 1)
    cell = jnp.where(matches.valid, cell, BIG)

    # Sort-free grouping: the (K, K) cell-equality matrix is one fused
    # pass; per-cell sums are one matmul; the first member of each cell is
    # its representative row.
    eq = (cell[:, None] == cell[None, :]) & matches.valid[:, None] & matches.valid[None, :]
    ii = jax.lax.broadcasted_iota(jnp.int32, (K, K), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (K, K), 1)
    first = matches.valid & ~jnp.any(eq & (jj < ii), axis=1)

    wh = rects[matches.template_id][:, 2:4].astype(jnp.float32)
    vals = jnp.stack(
        [
            matches.similarity,
            matches.x.astype(jnp.float32),
            matches.y.astype(jnp.float32),
            wh[:, 0],
            wh[:, 1],
        ],
        axis=1,
    )
    sums = eq.astype(jnp.float32) @ jnp.where(matches.valid[:, None], vals, 0.0)
    cnt = jnp.sum(eq, axis=1).astype(jnp.float32)
    c = jnp.maximum(cnt, 1.0)
    score = sums[:, 0] / c
    # Integer division like the reference's accumulating ints (C7).
    bbox = jnp.stack(
        [jnp.floor(sums[:, 1] / c), jnp.floor(sums[:, 2] / c),
         jnp.floor(sums[:, 3] / c), jnp.floor(sums[:, 4] / c)], axis=1,
    )

    head_valid = first & (cnt > filter_thresh)  # cluster_filter: <= thresh drops

    # Keep the biggest cells within the capacity (top_k over K heads).
    rank_key = jnp.where(head_valid, cnt, -1.0)
    _, rank = jax.lax.top_k(rank_key, max_cells)
    sel_valid = head_valid[rank]

    # Member lists: slot = rank of each member within its cell (matches
    # arrive similarity-descending from top-k, so ascending index order ==
    # best-first and capacity truncation keeps the best members).
    eq_sel = eq[rank]  # (C, K)
    slot = jnp.cumsum(eq_sel, axis=1) - 1  # member slot per column
    slot = jnp.where(eq_sel, slot, members_cap)  # park non-members
    member_idx = jnp.zeros((max_cells, members_cap), jnp.int32)
    member_idx = member_idx.at[
        jnp.arange(max_cells)[:, None], slot
    ].set(jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (max_cells, K)),
          mode="drop")
    member_valid = (
        sel_valid[:, None]
        & (jnp.arange(members_cap)[None, :] < jnp.minimum(cnt[rank], members_cap)[:, None])
    )

    return ClusterSet(
        score=jnp.where(sel_valid, score[rank], -1.0),
        count=cnt[rank].astype(jnp.int32),
        bbox=bbox[rank],
        valid=sel_valid,
        member_idx=member_idx,
        member_valid=member_valid,
    )


@jax.jit
def nms_iou(clusters: ClusterSet, iou_threshold: float) -> jnp.ndarray:
    """C7 greedy NMS on averaged bboxes, exact computeIoU semantics
    (inclusive pixel extents, rgbdDetector.cpp:533-574).  Returns keep mask."""
    C = clusters.score.shape[0]
    x, y, w, h = (clusters.bbox[:, i] for i in range(4))
    x2 = x + w - 1.0
    y2 = y + h - 1.0

    ix1 = jnp.maximum(x[:, None], x[None, :])
    ix2 = jnp.minimum(x2[:, None], x2[None, :])
    iy1 = jnp.maximum(y[:, None], y[None, :])
    iy2 = jnp.minimum(y2[:, None], y2[None, :])
    iw = jnp.maximum(ix2 - ix1 + 1.0, 0.0)
    ih = jnp.maximum(iy2 - iy1 + 1.0, 0.0)
    inter = iw * ih
    union = (w * h)[:, None] + (w * h)[None, :] - inter
    iou = inter / jnp.maximum(union, 1e-6)

    # Greedy: walk clusters by descending score; each still-alive cluster
    # suppresses strictly lower-ranked overlaps (rgbdDetector.cpp:497-518).
    order = jnp.argsort(-jnp.where(clusters.valid, clusters.score, -jnp.inf))
    rank_of = jnp.zeros((C,), jnp.int32).at[order].set(jnp.arange(C, dtype=jnp.int32))
    keep0 = clusters.valid

    def body(keep, i):
        idx = order[i]
        alive = keep[idx]
        sup = alive & (iou[idx] > iou_threshold) & (rank_of > i)
        return jnp.where(sup, False, keep), None

    keep, _ = jax.lax.scan(body, keep0, jnp.arange(C))
    return keep


def nms_rects(rects: jnp.ndarray, key: jnp.ndarray, valid: jnp.ndarray,
              iou_threshold: float) -> jnp.ndarray:
    """Greedy IoU NMS over (C, 4) int rects ranked by `key` (descending) —
    the pose-aware variant used when CascadeParams.nms_after_pose ranks
    overlapping posed clusters by verification instead of match score.
    Same inclusive-pixel IoU as nms_iou."""
    C = rects.shape[0]
    x, y, w, h = (rects[:, i].astype(jnp.float32) for i in range(4))
    x2 = x + w - 1.0
    y2 = y + h - 1.0
    ix1 = jnp.maximum(x[:, None], x[None, :])
    ix2 = jnp.minimum(x2[:, None], x2[None, :])
    iy1 = jnp.maximum(y[:, None], y[None, :])
    iy2 = jnp.minimum(y2[:, None], y2[None, :])
    iw = jnp.maximum(ix2 - ix1 + 1.0, 0.0)
    ih = jnp.maximum(iy2 - iy1 + 1.0, 0.0)
    inter = iw * ih
    union = (w * h)[:, None] + (w * h)[None, :] - inter
    iou = inter / jnp.maximum(union, 1e-6)

    order = jnp.argsort(-jnp.where(valid, key, -jnp.inf))
    rank_of = jnp.zeros((C,), jnp.int32).at[order].set(jnp.arange(C, dtype=jnp.int32))
    keep0 = valid

    def body(keep, i):
        idx = order[i]
        alive = keep[idx]
        sup = alive & (iou[idx] > iou_threshold) & (rank_of > i)
        return jnp.where(sup, False, keep), None

    keep, _ = jax.lax.scan(body, keep0, jnp.arange(C))
    return keep


# ---------------------------------------------------------------------------
# Rough pose + refinement per cluster
# ---------------------------------------------------------------------------


class ClusterPose(NamedTuple):
    pose: jnp.ndarray  # (4, 4) object pose in camera frame
    rect: jnp.ndarray  # (4,) int32 (x=avg match x, y=avg match y, w, h)
    score: jnp.ndarray  # cluster score
    icp_fitness: jnp.ndarray
    hv_rate: jnp.ndarray
    valid: jnp.ndarray  # bool
    rough_pose: jnp.ndarray  # (4, 4) pre-ICP pose (C8/C9 output) — the
    #   reference shows this stage in its PCL viewers (rgbdDetector.cpp:
    #   1299-1312); kept for per-stage observability (C23)
    hyp_sim: jnp.ndarray  # mean member match similarity of the SELECTED
    #   orientation hypothesis — the sharpest flip-disambiguation signal
    #   (the true orientation's templates out-match the symmetry partner)
    icp_iterations: jnp.ndarray  # ICP iterations run (all stages)


def _orientation_cluster_average(
    quats: jnp.ndarray,  # (M, 4) member template orientations
    Ts: jnp.ndarray,  # (M, 3)
    Ds: jnp.ndarray,  # (M,)
    Ods: jnp.ndarray,  # (M,)
    xs: jnp.ndarray,  # (M,)
    ys: jnp.ndarray,  # (M,)
    sims: jnp.ndarray,  # (M,) member match similarity (percent)
    mvalid: jnp.ndarray,  # (M,)
    th_deg: float,
    max_seeds: int,
    n_hyp: int = 1,
):
    """C8 front half: greedy-cluster member rotations against cluster seeds
    (compare to the seed = first member, rgbdDetector.cpp:604-631), then
    average the TOP `n_hyp` clusters' quats/translations/distances/
    positions (largest first — n_hyp=1 is the reference behavior; a second
    hypothesis carries the runner-up orientation group, which for visually
    near-symmetric objects is the symmetry partner that downstream
    verification can disambiguate).  All returns have a leading (n_hyp,)
    axis; `cnt` = member count per hypothesis (0 = empty slot)."""
    M = quats.shape[0]
    S = max_seeds
    cos_half_th = jnp.cos(jnp.radians(th_deg) / 2.0)

    def body(state, j):
        (seed_q, seed_on, cnt, sq, sT, sD, sOd, sx, sy, ssim) = state
        q = quats[j]
        dot = jnp.abs(jnp.sum(seed_q * q[None, :], axis=1))
        within = seed_on & (dot > cos_half_th)
        has = jnp.any(within)
        first = jnp.argmax(within)
        new_slot = jnp.sum(seed_on.astype(jnp.int32))
        slot = jnp.where(has, first, jnp.minimum(new_slot, S - 1))
        can_add = (~has) & (new_slot < S)
        do = mvalid[j] & (has | can_add)

        onehot = (jnp.arange(S) == slot) & do
        # Hemisphere-align member quat to its seed before accumulating.
        sgn = jnp.where(jnp.sum(seed_q[slot] * q) < 0, -1.0, 1.0)
        q_aligned = jnp.where(has, sgn * q, q)

        seed_q = jnp.where((onehot & ~has)[:, None], q[None, :], seed_q)
        seed_on = seed_on | (onehot & ~has)
        cnt = cnt + onehot.astype(jnp.int32)
        sq = sq + onehot[:, None] * q_aligned[None, :]
        sT = sT + onehot[:, None] * Ts[j][None, :]
        sD = sD + onehot * Ds[j]
        sOd = sOd + onehot * Ods[j]
        sx = sx + onehot * xs[j]
        sy = sy + onehot * ys[j]
        ssim = ssim + onehot * sims[j]
        return (seed_q, seed_on, cnt, sq, sT, sD, sOd, sx, sy, ssim), None

    init = (
        jnp.zeros((S, 4)),
        jnp.zeros((S,), bool),
        jnp.zeros((S,), jnp.int32),
        jnp.zeros((S, 4)),
        jnp.zeros((S, 3)),
        jnp.zeros((S,)),
        jnp.zeros((S,)),
        jnp.zeros((S,)),
        jnp.zeros((S,)),
        jnp.zeros((S,)),
    )
    (seed_q, seed_on, cnt, sq, sT, sD, sOd, sx, sy, ssim), _ = jax.lax.scan(
        body, init, jnp.arange(M)
    )
    top = jnp.argsort(-cnt)[:n_hyp]  # largest clusters first
    c = jnp.maximum(cnt[top], 1).astype(jnp.float32)
    q_avg = sq[top] / c[:, None]
    qn = jnp.linalg.norm(q_avg, axis=-1, keepdims=True)
    q_avg = jnp.where(
        qn > 1e-9, q_avg / jnp.maximum(qn, 1e-9),
        jnp.array([1.0, 0, 0, 0])[None, :],
    )
    return (
        q_avg,
        sT[top] / c[:, None],
        sD[top] / c,
        sOd[top] / c,
        jnp.floor(sx[top] / c).astype(jnp.int32),
        jnp.floor(sy[top] / c).astype(jnp.int32),
        ssim[top] / c,
        cnt[top],
    )


def _transplanted_scene_mask(
    mask: jnp.ndarray, rect: jnp.ndarray, X: jnp.ndarray, Y: jnp.ndarray, H: int, W: int
) -> jnp.ndarray:
    """Place the rendered mask (cropped at its bbox `rect`) at detected
    position (X, Y) — getPointCloudIndices mask overload semantics
    (rgbdDetector.cpp:1457-1487 region mapping via it->rect).

    Implemented as a 2-D TRANSLATION (static paste into a zero canvas,
    then a dynamic slice): the obvious (H, W) index-math formulation
    lowers to a generic per-pixel gather, while the paste+slice pair is
    two contiguous copies.

    The mask region outside its bbox `rect` must be zero for the two
    formulations to agree; a silhouette mask satisfies that by
    construction, and the rect-window test reduces to it."""
    mh, mw = mask.shape
    m8 = (mask > 0)
    # Canvas covers every placement with Y in [-mh, H+mh], X in [-mw, W+mw]
    # (the refine round can project partially off-frame); the final clip is
    # a formality for anything beyond that, where the mask is fully
    # off-screen anyway.
    canvas = jnp.zeros((2 * H + 2 * mh, 2 * W + 2 * mw), m8.dtype)
    canvas = jax.lax.dynamic_update_slice(canvas, m8, (H + mh, W + mw))
    # scene(yy, xx) = mask(yy - Y + r1, xx - X + r0)
    #              = canvas(H + mh + yy - Y + r1, W + mw + xx - X + r0)
    oy = jnp.clip(H + mh - Y + rect[1], 0, H + 2 * mh)
    ox = jnp.clip(W + mw - X + rect[0], 0, W + 2 * mw)
    return jax.lax.dynamic_slice(canvas, (oy, ox), (H, W))


def dilate_mask(mask: jnp.ndarray, px: int) -> jnp.ndarray:
    """4-connected binary dilation by `px` pixels WITHOUT wraparound: a
    jnp.roll formulation wraps at the array edges, so a mask clipped by the
    window/frame border would admit pixels from the opposite edge (scene
    points ~window-height away) into the ICP/HV scene set.  Pad-and-slice
    never crosses the boundary."""
    for _ in range(px):
        p = jnp.pad(mask, 1)
        mask = (
            p[1:-1, 1:-1]
            | p[:-2, 1:-1] | p[2:, 1:-1]
            | p[1:-1, :-2] | p[1:-1, 2:]
        )
    return mask


def _windowed_scene_extract(
    cloud: jnp.ndarray,  # (H, W, 3) organized scene cloud
    scene_normals: jnp.ndarray | None,  # (H, W, 3) or None
    mask: jnp.ndarray,  # (mh, mw) rendered silhouette
    rect: jnp.ndarray,  # (4,) mask bbox in render coords
    X: jnp.ndarray,  # transplant position (scene coords)
    Y: jnp.ndarray,
    dilate_px: int,
    cap: int,
):
    """Transplant the mask at (X, Y), dilate, and compact the masked scene
    points — all inside a (mh + pad, mw + pad) window around the
    transplant, so the per-pixel work (dilation, finite test, compaction
    scatter) scales with the OBJECT footprint, not the frame.

    Returns (pts (cap, 3), valid (cap,), normals (cap, 3) or None)."""
    H, W, _ = cloud.shape
    mh, mw = mask.shape
    pad = 2 * dilate_px + 8
    WH, WW = min(H, mh + pad), min(W, mw + pad)
    # Window anchored just above-left of the transplant (clipped in-frame).
    oy0 = jnp.clip(Y - pad // 2, 0, H - WH)
    ox0 = jnp.clip(X - pad // 2, 0, W - WW)
    win_mask = _transplanted_scene_mask_window(mask, rect, X, Y, oy0, ox0, WH, WW)
    win_mask = dilate_mask(win_mask, dilate_px)
    cloud_w = jax.lax.dynamic_slice(cloud, (oy0, ox0, jnp.int32(0)), (WH, WW, 3))
    sel = win_mask & jnp.all(jnp.isfinite(cloud_w), axis=-1)
    if scene_normals is None:
        pts, valid = _compact_points(cloud_w.reshape(-1, 3), sel.reshape(-1), cap)
        return pts, valid, None
    norm_w = jax.lax.dynamic_slice(
        scene_normals, (oy0, ox0, jnp.int32(0)), (WH, WW, 3)
    )
    return _compact_points(
        cloud_w.reshape(-1, 3), sel.reshape(-1), cap, norm_w.reshape(-1, 3)
    )


def _transplanted_scene_mask_window(
    mask: jnp.ndarray, rect: jnp.ndarray, X: jnp.ndarray, Y: jnp.ndarray,
    oy0: jnp.ndarray, ox0: jnp.ndarray, WH: int, WW: int
) -> jnp.ndarray:
    """_transplanted_scene_mask restricted to the (WH, WW) window whose
    scene-frame origin is (oy0, ox0): win(wy, wx) = scene(oy0+wy, ox0+wx)."""
    mh, mw = mask.shape
    m8 = mask > 0
    canvas = jnp.zeros((2 * WH + 2 * mh, 2 * WW + 2 * mw), m8.dtype)
    canvas = jax.lax.dynamic_update_slice(canvas, m8, (WH + mh, WW + mw))
    # win(wy, wx) = mask(oy0 + wy - Y + r1, ox0 + wx - X + r0)
    #            = canvas(WH + mh + oy0 + wy - Y + r1, ...)
    oy = jnp.clip(WH + mh + oy0 - Y + rect[1], 0, WH + 2 * mh)
    ox = jnp.clip(WW + mw + ox0 - X + rect[0], 0, WW + 2 * mw)
    return jax.lax.dynamic_slice(canvas, (oy, ox), (WH, WW))


def _compact_points(pts_flat: jnp.ndarray, sel_flat: jnp.ndarray, cap: int,
                    aux_flat: jnp.ndarray | None = None):
    """Compact up to `cap` selected points.  When more than `cap` points are
    selected, keep every k-th valid point (k = ceil(n/cap)) rather than the
    first `cap` in raster order: raster truncation keeps only the TOP rows
    of the object, and ICP on that sliver loses the pose information carried
    by the full outline (the strided subset covers the whole mask).

    `aux_flat` (N, 3) is gathered with the same selection (per-point
    normals for point-to-plane ICP); returns (pts, valid, aux) then."""
    n = jnp.sum(sel_flat)
    k = jnp.maximum((n + cap - 1) // cap, 1)
    rank = jnp.cumsum(sel_flat) - 1
    sel = sel_flat & (rank % k == 0)
    # Compact via cumsum + scatter-with-drop (the stable-argsort
    # formulation sorts the full 307k-pixel frame; the scatter is one
    # pass).  Output order (raster order of selected pixels) is identical.
    pos = jnp.where(sel, jnp.cumsum(sel) - 1, cap)
    pts = (
        jnp.full((cap, 3), pcu.SENTINEL, jnp.float32)
        .at[pos].set(pts_flat.astype(jnp.float32), mode="drop")
    )
    valid = jnp.arange(cap) < jnp.sum(sel)
    pts = jnp.where(valid[:, None], pts, pcu.SENTINEL)
    if aux_flat is None:
        return pts, valid
    aux = (
        jnp.zeros((cap, 3), jnp.float32)
        .at[pos].set(aux_flat.astype(jnp.float32), mode="drop")
    )
    return pts, valid, jnp.where(valid[:, None], aux, 0.0)


def rough_pose_and_refine(
    member_quats: jnp.ndarray,
    member_T: jnp.ndarray,
    member_D: jnp.ndarray,
    member_Od: jnp.ndarray,
    member_x: jnp.ndarray,
    member_y: jnp.ndarray,
    member_sims: jnp.ndarray,
    member_valid: jnp.ndarray,
    cluster_valid: jnp.ndarray,
    cluster_score: jnp.ndarray,
    cloud: jnp.ndarray,  # (H, W, 3) organized scene cloud (meters)
    triangles: jnp.ndarray,
    K_render: jnp.ndarray,
    params: CascadeParams,
    render_wh: tuple[int, int],
    scene_normals: jnp.ndarray | None = None,  # (H, W, 3) for point_to_plane
) -> ClusterPose:
    """C8 + C9(surface centroid) + C10 + C11 for ONE cluster (vmap over
    clusters at the call site)."""
    H, W = cloud.shape[:2]
    rw, rh = render_wh
    p2plane = params.icp_variant == "point_to_plane" and scene_normals is not None

    hq, hT, hD, hOd, hX, hY, hsim, hcnt = _orientation_cluster_average(
        member_quats, member_T, member_D, member_Od, member_x, member_y,
        member_sims, member_valid, params.orientation_clustering_th,
        params.max_seeds, n_hyp=params.orientation_hypotheses,
    )

    def _one_hypothesis(q_avg, T_aver, D_aver, Trans_aver, X, Y, hyp_sim, cnt):
        return _pose_one_hypothesis(
            q_avg, T_aver, D_aver, Trans_aver, X, Y, hyp_sim,
            hyp_on=cnt > 0,
            cluster_valid=cluster_valid, cluster_score=cluster_score,
            cloud=cloud, triangles=triangles, K_render=K_render,
            params=params, render_wh=render_wh, scene_normals=scene_normals,
            p2plane=p2plane,
        )

    poses_k = jax.vmap(_one_hypothesis)(hq, hT, hD, hOd, hX, hY, hsim, hcnt)
    if params.orientation_hypotheses == 1:
        return jax.tree_util.tree_map(lambda a: a[0], poses_k)
    # Hypothesis selection (measured on the symmetric-box eval): the mean
    # member MATCH SIMILARITY is the sharpest signal — the true
    # orientation's templates out-match the symmetry partner by 2-12 units
    # in every observed flip, while occupancy (hv) can favor the flip by a
    # hair when the box extents nearly tie.  Similarity leads (unit scale),
    # occupancy breaks sub-unit ties, ICP residual breaks those.  Empty
    # hypothesis slots are excluded.
    key = jnp.where(
        (hcnt > 0) & poses_k.valid,
        hsim + poses_k.hv_rate - 1e4 * poses_k.icp_fitness,
        -jnp.inf,
    )
    # If no hypothesis is valid, fall back to slot 0 (its valid flag
    # already records the failure).
    b = jnp.where(jnp.any(jnp.isfinite(key)), jnp.argmax(key), 0)
    return jax.tree_util.tree_map(lambda a: a[b], poses_k)


def inplane_sweep_fix(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_n: jnp.ndarray,
    scene_valid: jnp.ndarray,
    active: jnp.ndarray,
    sweep_deg: float,
    dominance: float,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Rank-deficiency repair for point-to-plane ICP (the face-on tail).

    When one plane dominates the visible scene surface, the point-to-plane
    normal equations are blind to rotation about its normal, so an initial
    in-plane offset (a view-sphere-neighbour template, ~3 deg) survives
    ICP untouched.  Nearest-neighbour scores cannot see that offset either
    at cascade sampling density (~900 pts/cloud): a rotated face point
    still lands ON the scene plane, so only a few corner slivers carry
    signal and the measured landscape is flat to 0.02% across +-5 deg.

    Instead, recover the offset in CLOSED FORM from each cloud's in-plane
    rectangle orientation: find the MODE scene normal by mean-shift (the
    mean normal of a multi-face view points between faces; the mode locks
    onto the dominant face — measured 0.996 aligned with the true error
    axis on a two-face 1.35 deg tail view), project both clouds onto that
    face's plane (points within 5 mm of the median plane depth — drops
    side faces the mis-posed render exposes), estimate each cloud's
    orientation by a full +-45 deg min-area bounding-box sweep (the bbox
    area of a rectangle is V-shaped in rotation, pi/2-periodic,
    extreme-point driven, and immune to the NN noise floor — a SQUARE
    face still carries mod-90 orientation through its corners), and
    rotate the model about the mode normal through its centroid by the
    orientation DIFFERENCE — plane distances are invariant, so ICP's
    converged depth alignment is preserved; the out-of-plane nudge this
    gives any secondary face is re-converged by the template-refinement
    ICP rounds that follow.

    The fix applies only when the in-plane mode is weakly constrained
    (fraction of scene normals within ~25 deg of the mode > dominance),
    BOTH clouds' bbox-area sweeps are modulated (>5% area swing across
    angles; a near-circular projection has no orientation), the two
    clouds' oriented-bbox dimensions agree within 10% (same physical
    rectangle — different visible extents make the orientation
    difference meaningless), and the correction is meaningful but
    bounded (0.25 deg <= |angle| <= sweep_deg).  The sweep grids are
    fixed (181 coarse x 21 fine); CascadeParams.inplane_sweep disables
    the stage wholesale.

    Returns (T_fix (4, 4), applied ()): T_fix is the identity when not
    applied."""
    nbar = pcu.masked_centroid(scene_n, scene_valid)
    n_dom = nbar / jnp.maximum(jnp.linalg.norm(nbar), 1e-9)
    # Mean-shift to the MODE normal: average the sign-folded normals
    # within ~25 deg of the current estimate (|dot| > 0.9), 4 rounds.
    # Keeps the previous direction when nothing aligns (a 50/50 two-face
    # tie folds to the diagonal, selects nothing, and the zero aligned
    # fraction blocks the fix — ICP is fully constrained there anyway).
    for _ in range(4):
        dots = scene_n @ n_dom
        w = scene_valid & (jnp.abs(dots) > 0.9)
        folded = jnp.where(w[:, None], scene_n * jnp.sign(dots)[:, None], 0.0)
        cand = jnp.sum(folded, axis=0)
        ok = jnp.linalg.norm(cand) > 1e-9
        n_dom = jnp.where(ok, cand / jnp.maximum(jnp.linalg.norm(cand), 1e-9),
                          n_dom)
    dom_frac = jnp.sum(
        (scene_valid & (jnp.abs(scene_n @ n_dom) > 0.9)).astype(jnp.float32)
    ) / jnp.maximum(jnp.sum(scene_valid), 1)
    deficient = dom_frac > dominance
    c0 = pcu.masked_centroid(model_pts, model_valid)

    # In-plane orthonormal basis (branchless seed choice).
    seed = jnp.where(jnp.abs(n_dom[0]) < 0.9,
                     jnp.array([1.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    e1 = jnp.cross(n_dom, seed)
    e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-9)
    e2 = jnp.cross(n_dom, e1)

    plane_eps = 5e-3  # m; render/sensor depth quantization is ~1-3 mm

    def _orientation(pts, valid):
        """(bbox angle, bbox dims at that angle, area modulation)."""
        depth = pts @ n_dom
        med = jnp.nanmedian(jnp.where(valid, depth, jnp.nan))
        keep = valid & (jnp.abs(depth - med) < plane_eps)
        cnt = jnp.maximum(jnp.sum(keep), 1)
        q = jnp.stack([pts @ e1, pts @ e2], axis=-1)
        cq = jnp.sum(jnp.where(keep[:, None], q, 0.0), axis=0) / cnt
        qc = q - cq[None, :]

        def _dims(th):
            c, s = jnp.cos(th), jnp.sin(th)
            x = qc[:, 0] * c + qc[:, 1] * s
            y = -qc[:, 0] * s + qc[:, 1] * c
            xk = jnp.where(keep, x, jnp.inf)
            yk = jnp.where(keep, y, jnp.inf)
            xK = jnp.where(keep, x, -jnp.inf)
            yK = jnp.where(keep, y, -jnp.inf)
            return jnp.stack([jnp.max(xK) - jnp.min(xk),
                              jnp.max(yK) - jnp.min(yk)])

        def _area(th):
            d = _dims(th)
            return d[0] * d[1]

        quarter_half = jnp.pi / 4.0
        a1s = jnp.linspace(-quarter_half, quarter_half, 181)
        ar1 = jax.vmap(_area)(a1s)
        b1 = a1s[jnp.argmin(ar1)]
        half_deg = jnp.pi / 360.0
        a2s = b1 + jnp.linspace(-half_deg, half_deg, 21)
        ar2 = jax.vmap(_area)(a2s)
        b2 = a2s[jnp.argmin(ar2)]
        modulation = jnp.max(ar1) / jnp.maximum(jnp.min(ar1), 1e-12)
        return b2, _dims(b2), modulation

    ang_m, dims_m, mod_m = _orientation(model_pts, model_valid)
    ang_s, dims_s, mod_s = _orientation(scene_pts, scene_valid)
    mod_ok = (mod_m > 1.05) & (mod_s > 1.05)
    # Same physical rectangle: the two clouds' oriented-bbox dimensions
    # must agree (0.3-2.4% on the real tail views) — a dominance-passing
    # view whose clouds expose DIFFERENT extents would otherwise receive
    # a spurious orientation difference.
    dims_ok = jnp.all(
        jnp.abs(dims_m - dims_s)
        < 0.1 * jnp.maximum(jnp.maximum(dims_m, dims_s), 1e-6)
    )
    # Rectangle orientation is pi/2-periodic; wrap to (-45, 45] deg.
    quarter = jnp.pi / 2.0
    best = jnp.mod(ang_s - ang_m + quarter / 2, quarter) - quarter / 2
    cap = sweep_deg * jnp.pi / 180.0
    min_fix = 0.25 * jnp.pi / 180.0
    applied = (active & deficient & dims_ok & mod_ok
               & (jnp.abs(best) <= cap) & (jnp.abs(best) >= min_fix))

    Kx = jnp.array([
        [0.0, -n_dom[2], n_dom[1]],
        [n_dom[2], 0.0, -n_dom[0]],
        [-n_dom[1], n_dom[0], 0.0],
    ])

    def _rot(th):
        return jnp.eye(3) + jnp.sin(th) * Kx + (1 - jnp.cos(th)) * (Kx @ Kx)

    import os as _os
    if _os.environ.get("LPE_DEBUG_SWEEP"):
        jax.debug.print(
            "[sweep] active={a} dom_frac={d:.4f} deficient={df} "
            "ang_m={am:.3f} ang_s={asc:.3f} best_deg={b:.3f} "
            "mod={nm:.2f}/{ns:.2f} dims_ok={dk} applied={ap}",
            a=active, d=dom_frac, df=deficient,
            am=ang_m * 180.0 / jnp.pi, asc=ang_s * 180.0 / jnp.pi,
            b=best * 180.0 / jnp.pi, nm=mod_m, ns=mod_s, dk=dims_ok,
            ap=applied,
        )
    Rb = _rot(jnp.where(applied, best, 0.0))
    T_fix = geo.make_transform(Rb, c0 - Rb @ c0)
    return T_fix, applied


def _pose_one_hypothesis(
    q_avg, T_aver, D_aver, Trans_aver, X, Y, hyp_sim,
    *, hyp_on, cluster_valid, cluster_score, cloud, triangles, K_render,
    params: CascadeParams, render_wh, scene_normals, p2plane,
) -> ClusterPose:
    """Render + position strategy + ICP + HV for ONE orientation
    hypothesis of one cluster (the body of rough_pose_and_refine)."""
    H, W = cloud.shape[:2]
    rw, rh = render_wh
    R_avg = geo.quat_to_matrix(q_avg)
    # Vmapped while_loops iterate until the SLOWEST lane converges, and an
    # invalid cluster / empty hypothesis slot fed garbage clouds can
    # oscillate for the full 150-iteration budget, dominating the whole
    # pose stage.  Masking
    # the lane's model points makes its ICP delta the identity, so it
    # converges on the first iteration and stops costing anything.
    active = cluster_valid & hyp_on

    # Re-render at the averaged pose (renderDepthOnly/renderImageOnly at
    # -T_match with up = -row1(R), rgbdDetector.cpp:712-721).  The object
    # projects at the principal point, so a centered viewport window with
    # cx = cy = VP/2 rasterizes the same rays at a fraction of the pixels.
    vp = params.render_viewport
    if vp and vp < min(rw, rh):
        K_r = K_render.at[0, 2].set(vp / 2.0).at[1, 2].set(vp / 2.0)
        r_w = r_h = vp
    else:
        K_r, r_w, r_h = K_render, rw, rh
    out = render_fn(triangles, R_avg.astype(jnp.float32), T_aver.astype(jnp.float32),
                    K_r, r_w, r_h)
    depth_m = out.depth_mm / 1000.0

    # Model cloud: depthTo3d of the rendered view, masked (cpp:795-812).
    mcloud = pcu.depth_to_cloud(depth_m, K_r)
    msel = (out.mask > 0) & jnp.all(jnp.isfinite(mcloud), axis=-1) & active
    model_pts, model_valid = _compact_points(
        mcloud.reshape(-1, 3), msel.reshape(-1), params.model_cap
    )

    # Scene cloud: rendered mask transplanted to the detected (X, Y),
    # extracted from a mask-sized WINDOW of the frame rather than the full
    # 307k-pixel plane (the full-frame compaction scatter was one of the
    # pose stage's hottest ops; the transplanted mask can never exceed the
    # render viewport, so everything outside the window is dead work).
    scene_pts, scene_valid, scene_n = _windowed_scene_extract(
        cloud, scene_normals if p2plane else None, out.mask, out.rect,
        X + params.bias_x, Y, params.scene_mask_dilate_px, params.scene_cap,
    )

    # Outlier removal + voxel downsampling (cpp:841-850).
    scene_valid = pcu.statistical_outlier_removal(
        scene_pts, scene_valid, params.sor_mean_k, params.sor_std_mul
    )
    if p2plane:
        scene_pts, scene_valid, scene_n = pcu.voxel_grid_filter(
            scene_pts, scene_valid, params.voxel_leaf, params.scene_cap,
            aux=scene_n,
        )
        scene_n = scene_n / jnp.maximum(
            jnp.linalg.norm(scene_n, axis=-1, keepdims=True), 1e-9
        )
    else:
        scene_pts, scene_valid = pcu.voxel_grid_filter(
            scene_pts, scene_valid, params.voxel_leaf, params.scene_cap
        )
    model_pts, model_valid = pcu.voxel_grid_filter(
        model_pts, model_valid, params.voxel_leaf, params.model_cap
    )

    # Initial pose: averaged R, z = averaged Ori_dist (cpp:788-790).
    pose0 = geo.make_transform(R_avg, jnp.array([0.0, 0.0, 1.0]) * Trans_aver)

    # C9 position strategy.
    if params.position_strategy == "roi_center":
        # Scene point at the detection ROI center vs model cloud center
        # (getPositionByROICenter, cpp:1027-1060; the reference's NaN-walk
        # along +x becomes nearest-finite-to-center).
        cy = jnp.clip(Y + out.rect[3] // 2, 0, H - 1)
        cx = jnp.clip(X + params.bias_x + out.rect[2] // 2, 0, W - 1)
        scene_pt = cloud[cy, cx]
        scene_pt = jnp.where(
            jnp.all(jnp.isfinite(scene_pt)),
            scene_pt,
            pcu.nearest_point(scene_pts, scene_valid, pcu.masked_centroid(scene_pts, scene_valid)),
        )
        model_pt = pcu.nearest_point(
            model_pts, model_valid, jnp.array([0.0, 0.0, 1.0]) * Trans_aver
        )
        tshift = scene_pt - model_pt
    elif params.position_strategy == "distance_offset":
        # Bbox-center scene point (centroid fallback), z += D unless the
        # model has a center hole (getPositionByDistanceOffset, cpp:984-1025).
        cy = jnp.clip(Y + out.rect[3] // 2, 0, H - 1)
        cx = jnp.clip(X + params.bias_x + out.rect[2] // 2, 0, W - 1)
        scene_pt = cloud[cy, cx]
        scene_pt = jnp.where(
            jnp.all(jnp.isfinite(scene_pt)),
            scene_pt,
            pcu.masked_centroid(scene_pts, scene_valid),
        )
        if not params.distance_offset_uses_hole:
            scene_pt = scene_pt.at[2].add(D_aver)
        tshift = scene_pt - jnp.array([0.0, 0.0, 1.0]) * Trans_aver
    elif params.position_strategy == "local_descriptor":
        # SHOT + Hough-3D correspondence grouping between the rendered model
        # cloud and the scene ROI (getPoseByLocalDescriptor, cpp:867-1000):
        # recovers a FULL rigid transform (rotation and translation) without
        # ICP; on success it composes onto the rough pose and the ICP stages
        # start from it.  Falls back to surface-centroid pairing when the
        # Hough vote count is below threshold.
        from ..ops.local_descriptor import get_pose_by_local_descriptor

        ld = get_pose_by_local_descriptor(
            model_pts, model_valid, scene_pts, scene_valid,
            keypoint_leaf=params.ld_keypoint_leaf,
            descr_radius=params.ld_descr_radius,
            lrf_radius=params.ld_lrf_radius,
            bin_size=params.ld_bin_size,
            k_cap=params.ld_keypoint_cap,
            min_votes=params.ld_min_votes,
        )
        sc = pcu.masked_centroid(scene_pts, scene_valid)
        mc = pcu.masked_centroid(model_pts, model_valid)
        s_surf = pcu.nearest_point(scene_pts, scene_valid, sc)
        m_surf = pcu.nearest_point(model_pts, model_valid, mc)
        fb_shift = s_surf - m_surf
        fb_pose = pose0.at[:3, 3].set(jnp.array([0.0, 0.0, Trans_aver]) + fb_shift)
        fb_model = model_pts + fb_shift[None, :]
        pose0 = jnp.where(ld.valid, ld.pose @ pose0, fb_pose)
        model_pts_t = jnp.where(
            ld.valid,
            model_pts @ ld.pose[:3, :3].T + ld.pose[:3, 3],
            fb_model,
        )
    else:
        # Surface-centroid pairing (cpp:1062-1131, the active strategy):
        # translate model so the surface point nearest its centroid lands on
        # the scene's.
        sc = pcu.masked_centroid(scene_pts, scene_valid)
        mc = pcu.masked_centroid(model_pts, model_valid)
        s_surf = pcu.nearest_point(scene_pts, scene_valid, sc)
        m_surf = pcu.nearest_point(model_pts, model_valid, mc)
        tshift = s_surf - m_surf
    if params.position_strategy != "local_descriptor":
        pose0 = pose0.at[:3, 3].set(jnp.array([0.0, 0.0, Trans_aver]) + tshift)
        model_pts_t = model_pts + tshift[None, :]

    # ICP (coarse + fine) — pose = tf @ pose (cpp:1328-1331, 1363-1368);
    # the "nonlinear" variant runs the 3-pass LM schedule instead
    # (icpNonLinearPoseRefine, cpp:1508-1600); "point_to_plane" swaps the
    # Kabsch update for the plane-residual Gauss-Newton (ops.icp.icp_plane
    # — the accuracy config: immune to the sparse-sampling noise floor).
    if p2plane:
        # The plane variant converges in <10 iterations on real clusters;
        # junk-but-valid clutter lanes never converge and would otherwise
        # spin the whole vmapped loop for the full reference budget.
        icp_res = icp_two_stage_plane(
            model_pts_t, model_valid, scene_pts, scene_n, scene_valid,
            coarse_iterations=min(params.icp_max_iter, 40),
            coarse_corr_dist=params.icp_max_corr_dist,
            coarse_rejection=params.icp_ransac_thresh,
            transform_epsilon=params.icp_tr_epsilon,
            fine_iterations=params.icp_fine_iter,
            fine_corr_dist=params.icp_fine_corr_dist,
            fine_rejection=params.icp_fine_ransac,
        )
    elif params.icp_variant == "nonlinear":
        icp_res = icp_nonlinear_schedule(
            model_pts_t, model_valid, scene_pts, scene_valid
        )
    else:
        icp_res = icp_two_stage(
            model_pts_t, model_valid, scene_pts, scene_valid,
            coarse_iterations=params.icp_max_iter,
            coarse_corr_dist=params.icp_max_corr_dist,
            coarse_rejection=params.icp_ransac_thresh,
            transform_epsilon=params.icp_tr_epsilon,
            fine_iterations=params.icp_fine_iter,
            fine_corr_dist=params.icp_fine_corr_dist,
            fine_rejection=params.icp_fine_ransac,
        )
    pose = icp_res.transform @ pose0
    model_final = model_pts_t @ icp_res.transform[:3, :3].T + icp_res.transform[:3, 3]
    hv_model_valid = model_valid

    if p2plane and params.inplane_sweep:
        import os as _os
        if _os.environ.get("LPE_DUMP_SWEEP"):
            def _dump(mp, mv, sp, sn, sv, act):
                import numpy as _np
                if bool(act):
                    _np.savez(_os.environ["LPE_DUMP_SWEEP"],
                              model=_np.asarray(mp), mvalid=_np.asarray(mv),
                              scene=_np.asarray(sp), snorm=_np.asarray(sn),
                              svalid=_np.asarray(sv))
            jax.debug.callback(_dump, model_final, model_valid, scene_pts,
                               scene_n, scene_valid, active)
        T_fix, _applied = inplane_sweep_fix(
            model_final, model_valid, scene_pts, scene_n, scene_valid,
            active, params.inplane_sweep_deg, params.inplane_dominance,
        )
        pose = T_fix @ pose
        model_final = model_final @ T_fix[:3, :3].T + T_fix[:3, 3]

    # Template-refinement rounds (carmine templateRefinement, carmine:
    # 555-652).  Render the object ON the optical axis at distance |t| with
    # the refined rotation (the same convention as the rough-pose render),
    # then translate the cloud by t - (0, 0, |t|): exactly the model surface
    # at the refined pose, with no surface-centroid approximation.
    #
    # Crucially, the SCENE side is also re-extracted: the reference ICPs the
    # refined model against the WHOLE scene cloud (carmine:609-613 passes
    # pc_ptr, not a masked subset), so it carries no stale-mask bias.  The
    # first-pass mask here sits at the MATCH position (T0-1 px plateau, so
    # up to ~4-5 px off), which clips one object edge and biases ICP
    # rotation by ~px/extent; re-transplanting the mask at the REFINED
    # pose's sub-pixel image projection removes that bias — without paying
    # the reference's full-cloud correspondence cost.
    for _ in range(params.refine_rounds):
        Rp = pose[:3, :3]
        tp = pose[:3, 3]
        # TRUE off-axis render at the refined pose: X_cam = Rp X + tp
        # (render_fn computes R @ (X + T), so T = Rp^T tp).  The rough
        # stage's on-axis-render-then-shift trick has WRONG self-occlusion
        # for off-axis objects (parallax: the visible surface depends on
        # the view ray), and ICP against that model dragged already-correct
        # poses by ~0.5 deg.  Rendering from the actual eye point (what the
        # reference's templateRefinement does via eye/look_at,
        # carmine:560-573) makes the model surface exactly the visible one.
        # The viewport stays small: an r_w x r_h window of the full image
        # centered on the object's projection (principal point shifted by
        # the integer window origin).
        zz = jnp.maximum(tp[2], 1e-3)
        u = K_render[0, 0] * tp[0] / zz + K_render[0, 2]
        v = K_render[1, 1] * tp[1] / zz + K_render[1, 2]
        ox = jnp.round(u).astype(jnp.int32) - r_w // 2
        oy = jnp.round(v).astype(jnp.int32) - r_h // 2
        K_vp = (
            K_render.astype(jnp.float32)
            .at[0, 2].add(-ox.astype(jnp.float32))
            .at[1, 2].add(-oy.astype(jnp.float32))
        )
        out_r = render_fn(
            triangles, Rp.astype(jnp.float32),
            (Rp.T @ tp).astype(jnp.float32), K_vp, r_w, r_h,
        )
        rc = pcu.depth_to_cloud(out_r.depth_mm / 1000.0, K_vp)
        rsel = (out_r.mask > 0) & jnp.all(jnp.isfinite(rc), axis=-1) & active
        rpts, rvalid = _compact_points(
            rc.reshape(-1, 3), rsel.reshape(-1), params.model_cap
        )
        rpts, rvalid = pcu.voxel_grid_filter(
            rpts, rvalid, params.voxel_leaf, params.model_cap
        )

        # Scene re-extraction at the refined pose: the rendered mask IS the
        # object's scene silhouette (same rays); transplant by the window
        # origin only — sub-pixel correct, no match-plateau bias.
        spts_r, sval_r, sn_r = _windowed_scene_extract(
            cloud, scene_normals if p2plane else None, out_r.mask, out_r.rect,
            out_r.rect[0] + ox, out_r.rect[1] + oy,
            params.scene_mask_dilate_px, params.scene_cap,
        )
        sval_r = pcu.statistical_outlier_removal(
            spts_r, sval_r, params.sor_mean_k, params.sor_std_mul
        )
        if p2plane:
            spts_r, sval_r, sn_r = pcu.voxel_grid_filter(
                spts_r, sval_r, params.voxel_leaf, params.scene_cap, aux=sn_r
            )
            sn_r = sn_r / jnp.maximum(
                jnp.linalg.norm(sn_r, axis=-1, keepdims=True), 1e-9
            )
        else:
            spts_r, sval_r = pcu.voxel_grid_filter(
                spts_r, sval_r, params.voxel_leaf, params.scene_cap
            )
        # Fall back to the first-pass scene set if re-extraction found
        # nothing (pose walked off-frame).
        ok_r = jnp.sum(sval_r) >= 16
        spts_r = jnp.where(ok_r, spts_r, scene_pts)
        sval_r = jnp.where(ok_r, sval_r, scene_valid)

        if p2plane:
            sn_r = jnp.where(ok_r, sn_r, scene_n)
            rr = icp_two_stage_plane(
                rpts, rvalid, spts_r, sn_r, sval_r,
                coarse_iterations=params.refine_icp_iter,
                coarse_corr_dist=params.icp_fine_corr_dist * 2.0,
                coarse_rejection=params.icp_fine_ransac,
                transform_epsilon=params.icp_tr_epsilon,
                fine_iterations=params.icp_fine_iter,
                fine_corr_dist=params.icp_fine_corr_dist,
                fine_rejection=params.icp_fine_ransac,
            )
        else:
            rr = icp_two_stage(
                rpts, rvalid, spts_r, sval_r,
                coarse_iterations=params.refine_icp_iter,
                coarse_corr_dist=params.icp_fine_corr_dist * 2.0,
                coarse_rejection=params.icp_fine_ransac,
                transform_epsilon=params.icp_tr_epsilon,
                fine_iterations=params.icp_fine_iter,
                fine_corr_dist=params.icp_fine_corr_dist,
                fine_rejection=params.icp_fine_ransac,
            )
        pose = rr.transform @ pose
        icp_res = icp_res._replace(fitness=rr.fitness)
        model_final = rpts @ rr.transform[:3, :3].T + rr.transform[:3, 3]
        hv_model_valid = rvalid
        scene_pts, scene_valid = spts_r, sval_r
        if p2plane:
            scene_n = sn_r

    # Hypothesis verification: voxel-occupancy rate (cpp:1457-1506).
    hv_rate = pcu.voxel_occupancy_rate(
        model_final, hv_model_valid, scene_pts, scene_valid, params.hv_resolution
    )
    hv_ok = (~jnp.array(params.enable_hv)) | (hv_rate >= params.hv_threshold)

    # Canonicalization (C22).
    R = pose[:3, :3]
    if params.canonicalize == "x_front":
        # service.cpp:562-583
        def flip_x(R):
            R = R.at[:, 0].set(-R[:, 0])
            return jax.lax.cond(
                R[1, 1] > 0,
                lambda R: R.at[:, 1].set(-R[:, 1]),
                lambda R: R.at[:, 2].set(-R[:, 2]),
                R,
            )

        def keep_x(R):
            return jax.lax.cond(
                R[1, 1] > 0,
                lambda R: R.at[:, 1].set(-R[:, 1]).at[:, 2].set(-R[:, 2]),
                lambda R: R,
                R,
            )

        R = jax.lax.cond(R[0, 0] < 0, flip_x, keep_x, R)
    elif params.canonicalize == "z_down":
        # carmine:487-495
        R = jax.lax.cond(
            R[2, 2] < 0,
            lambda R: R.at[:, 0].set(-R[:, 0]).at[:, 2].set(-R[:, 2]),
            lambda R: R,
            R,
        )
    pose = pose.at[:3, :3].set(R)

    rect = jnp.stack([X, Y, out.rect[2], out.rect[3]])
    # num_inliers == 0 means the ICP never found a single correspondence —
    # the "pose" is untethered to the scene (its fitness is a vacuous 0.0,
    # which would otherwise LOOK perfect to any fitness-ranked selection).
    ok = (
        cluster_valid & hv_ok
        & (jnp.sum(scene_valid) > 10) & (jnp.sum(model_valid) > 10)
        & (icp_res.num_inliers > 0)
    )
    return ClusterPose(
        pose=pose, rect=rect, score=cluster_score,
        icp_fitness=icp_res.fitness, hv_rate=hv_rate, valid=ok,
        rough_pose=pose0, hyp_sim=hyp_sim,
        icp_iterations=icp_res.iterations,
    )
