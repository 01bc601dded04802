"""Point-to-point ICP as a fixed-shape JAX loop.

Device-side replacement for the reference's two-pass PCL ICP refinement
(rgbdDetector::icpPoseRefine, rgbdDetector.cpp:1263-1412): brute-force
nearest-neighbour correspondence via a pairwise-distance matmul
(clouds are a few thousand points — a (M, S) distance matrix is tiny),
distance-gated correspondence rejection (the moral equivalent of PCL's
max-correspondence-distance + RANSAC outlier threshold), closed-form
Umeyama/Kabsch update via 3x3 SVD, iterated under `lax.while_loop` with a
transform-epsilon early stop.

The reference's schedule (coarse: argv params e.g. 150 it / 0.05 corr /
RANSAC 0.02; fine: 20 it / 0.01 corr / RANSAC 0.01 — service launch args and
rgbdDetector.cpp:1349-1366) is reproduced by `icp_two_stage`.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.pointcloud import pairwise_sq_dists


def _f32_matmuls(fn):
    """Pin true-f32 matmuls for the geometry solves at TRACE time.

    Reduced-precision f32 matmuls (bf16 passes, or TF32 on a GPU) are a
    correctness hazard for ICP: the pairwise-distance expansion cancels
    catastrophically and NN assignment becomes noise.  The package sets
    jax_default_matmul_precision globally at import, but that is a
    mutable global a user's own config.update can silently reset; this
    context pins the precision for everything traced inside these solvers
    regardless of ambient config."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


class ICPResult(NamedTuple):
    transform: jnp.ndarray  # (4, 4) source -> target
    fitness: jnp.ndarray  # mean squared inlier distance
    num_inliers: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray  # bool


def _kabsch(src: jnp.ndarray, dst: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted rigid alignment src->dst: (4,4) transform."""
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    cs = jnp.sum(src * w[:, None], axis=0) / wsum
    cd = jnp.sum(dst * w[:, None], axis=0) / wsum
    H = ((src - cs) * w[:, None]).T @ (dst - cd)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    S = jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, d]))
    R = Vt.T @ S @ U.T
    t = cd - R @ cs
    T = jnp.eye(4)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


@partial(jax.jit, static_argnames=("max_iterations",))
@_f32_matmuls
def icp(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_valid: jnp.ndarray,
    max_iterations: int = 50,
    max_corr_dist: float = 0.05,
    rejection_dist: float = 0.02,
    transform_epsilon: float = 1e-5,
) -> ICPResult:
    """Align model (source) onto scene (target); returns the source->target
    transform like PCL's getFinalTransformation (pose update is
    `tf @ pose`, ref rgbdDetector.cpp:1328-1331)."""
    corr2 = max_corr_dist * max_corr_dist
    rej2 = rejection_dist * rejection_dist
    scene_safe = jnp.where(scene_valid[:, None], scene_pts, 1e6)

    def cond(state):
        T, it, done, _, _ = state
        return (it < max_iterations) & (~done)

    def body(state):
        T, it, _, _, _ = state
        cur = model_pts @ T[:3, :3].T + T[:3, 3]
        d2 = pairwise_sq_dists(cur, scene_safe)  # (M, S)
        nn = jnp.argmin(d2, axis=1)
        nd2 = jnp.min(d2, axis=1)
        # Distance-gated rejection: PCL gates at max_corr_dist then RANSAC-
        # rejects residuals beyond `rejection_dist`; we gate at min of both
        # (with slack on the rejection radius while far from convergence).
        w = (model_valid & (nd2 < jnp.minimum(corr2, rej2 * 4))).astype(jnp.float32)
        tgt = scene_safe[nn]
        delta = _kabsch(cur, tgt, w)
        Tn = delta @ T
        # Convergence: PCL transformation_epsilon compares successive
        # transforms; use rotation/translation increment magnitude.
        dr = jnp.sum((delta[:3, :3] - jnp.eye(3)) ** 2)
        dt = jnp.sum(delta[:3, 3] ** 2)
        done = (dr + dt) < transform_epsilon
        fit = jnp.sum(nd2 * w) / jnp.maximum(jnp.sum(w), 1.0)
        return (Tn, it + 1, done, fit, jnp.sum(w))

    T0 = jnp.eye(4)
    state = (T0, jnp.int32(0), jnp.array(False), jnp.array(jnp.inf), jnp.array(0.0))
    T, it, done, fit, ninl = jax.lax.while_loop(cond, body, state)
    return ICPResult(T, fit, ninl.astype(jnp.int32), it, done)


@_f32_matmuls
def icp_schedule(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_valid: jnp.ndarray,
    stages: tuple[tuple[int, float, float, float], ...],
) -> ICPResult:
    """Run a multi-pass ICP schedule; each stage is (max_iterations,
    max_corr_dist, rejection_dist, transform_epsilon) and starts from the
    previous stage's alignment (pose accumulates as tf_n @ ... @ tf_1).

    Generalizes the reference's two-pass icpPoseRefine and the three-pass
    icpNonLinearPoseRefine (rgbdDetector.cpp:1263-1412, 1508-1600; the
    nonlinear variant's LM inner loop is replaced by our closed-form Kabsch
    updates, which converge on the same point-to-point objective).
    """
    T_acc = jnp.eye(4)
    pts = model_pts
    fit = jnp.array(jnp.inf)
    ninl = jnp.array(0, jnp.int32)
    iters = jnp.array(0, jnp.int32)
    conv = jnp.array(False)
    for max_it, corr, rej, eps in stages:
        r = icp(
            pts, model_valid, scene_pts, scene_valid,
            max_iterations=max_it, max_corr_dist=corr,
            rejection_dist=rej, transform_epsilon=eps,
        )
        pts = pts @ r.transform[:3, :3].T + r.transform[:3, 3]
        T_acc = r.transform @ T_acc
        fit, ninl, conv = r.fitness, r.num_inliers, conv | r.converged
        iters = iters + r.iterations
    return ICPResult(T_acc, fit, ninl, iters, conv)


def _p2plane_delta(cur: jnp.ndarray, tgt: jnp.ndarray, n_tgt: jnp.ndarray,
                   w: jnp.ndarray) -> jnp.ndarray:
    """One Gauss-Newton step on the point-to-PLANE objective
    sum_i w_i (n_i . (cur_i - tgt_i))^2, linearized about identity with a
    twist (omega, t): residual Jacobian rows are [cur_i x n_i, n_i].

    Point-to-plane is the cure for the point-to-point noise floor on this
    workload: capped/voxelized model and scene clouds sample the SAME
    surface at different pixel/voxel phases, so sample-to-sample Kabsch
    carries a mm-scale alignment noise that costs ~1-2 deg on a 10 cm
    object, while distance-to-local-plane is invariant to where on the
    face the samples sit (and converges in a fraction of the iterations on
    flat geometry — PCL's WithNormals transform estimator is the same
    idea).

    On a face-on view the visible surface is ONE plane and the pure
    plane system is rank-3-deficient (in-plane translation and rotation
    about the normal are unconstrained; the solve explodes along the null
    space — observed: 108 degrees in 10 iterations).  A small point-to-
    point term (alpha) regularizes to full rank — NN correspondences
    anchor the tangential directions — and a per-step trust region caps
    whatever noise still leaks through."""
    alpha = 0.1
    r = jnp.sum(n_tgt * (cur - tgt), axis=1)  # (N,)
    Jr = jnp.concatenate([jnp.cross(cur, n_tgt), n_tgt], axis=1)  # (N, 6)
    Jw = Jr * w[:, None]
    JtJ = jnp.einsum("ni,nj->ij", Jw, Jr)
    Jtr = Jw.T @ r
    # Point-to-point block: residual (cur - tgt), Jacobian rows
    # [-[cur]_x | I] per component (same linearization as _lm_step).
    rp = cur - tgt  # (N, 3)
    zeros = jnp.zeros_like(cur[:, 0])
    cx = jnp.stack(
        [
            jnp.stack([zeros, cur[:, 2], -cur[:, 1]], axis=1),
            jnp.stack([-cur[:, 2], zeros, cur[:, 0]], axis=1),
            jnp.stack([cur[:, 1], -cur[:, 0], zeros], axis=1),
        ],
        axis=1,
    )  # (N, 3, 3)
    Jp = jnp.concatenate([cx, jnp.broadcast_to(jnp.eye(3), cx.shape)], axis=2)
    Jpw = Jp * w[:, None, None]
    JtJ = JtJ + alpha * jnp.einsum("nij,nik->jk", Jpw, Jp)
    Jtr = Jtr + alpha * jnp.einsum("nij,ni->j", Jpw, rp)
    A = JtJ + 1e-9 * jnp.eye(6)
    delta = -jnp.linalg.solve(A, Jtr)
    omega, t = delta[:3], delta[3:]
    # Trust region: one ICP step never needs more than ~0.1 rad / 5 cm.
    scale = jnp.minimum(
        1.0,
        jnp.minimum(
            0.1 / (jnp.linalg.norm(omega) + 1e-12),
            0.05 / (jnp.linalg.norm(t) + 1e-12),
        ),
    )
    omega, t = omega * scale, t * scale
    th = jnp.linalg.norm(omega) + 1e-12
    k = omega / th
    K = jnp.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    R = jnp.eye(3) + jnp.sin(th) * K + (1.0 - jnp.cos(th)) * (K @ K)
    return jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)


@partial(jax.jit, static_argnames=("max_iterations",))
@_f32_matmuls
def icp_plane(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_normals: jnp.ndarray,
    scene_valid: jnp.ndarray,
    max_iterations: int = 50,
    max_corr_dist: float = 0.05,
    rejection_dist: float = 0.02,
    transform_epsilon: float = 1e-5,
) -> ICPResult:
    """Point-to-plane ICP (scene normals per scene point, camera-oriented).

    Same correspondence gating and convergence contract as `icp`; the
    update is the Gauss-Newton point-to-plane solve instead of Kabsch.
    Fitness stays the point-to-POINT mean squared inlier distance so it is
    comparable across variants."""
    corr2 = max_corr_dist * max_corr_dist
    rej2 = rejection_dist * rejection_dist
    scene_safe = jnp.where(scene_valid[:, None], scene_pts, 1e6)

    def cond(state):
        T, it, done, _, _ = state
        return (it < max_iterations) & (~done)

    def body(state):
        T, it, _, _, _ = state
        cur = model_pts @ T[:3, :3].T + T[:3, 3]
        d2 = pairwise_sq_dists(cur, scene_safe)
        nn = jnp.argmin(d2, axis=1)
        nd2 = jnp.min(d2, axis=1)
        w = (model_valid & (nd2 < jnp.minimum(corr2, rej2 * 4))).astype(jnp.float32)
        tgt = scene_safe[nn]
        n_tgt = scene_normals[nn]
        delta = _p2plane_delta(cur, tgt, n_tgt, w)
        Tn = delta @ T
        dr = jnp.sum((delta[:3, :3] - jnp.eye(3)) ** 2)
        dt = jnp.sum(delta[:3, 3] ** 2)
        done = (dr + dt) < transform_epsilon
        fit = jnp.sum(nd2 * w) / jnp.maximum(jnp.sum(w), 1.0)
        return (Tn, it + 1, done, fit, jnp.sum(w))

    state = (jnp.eye(4), jnp.int32(0), jnp.array(False), jnp.array(jnp.inf),
             jnp.array(0.0))
    T, it, done, fit, ninl = jax.lax.while_loop(cond, body, state)
    return ICPResult(T, fit, ninl.astype(jnp.int32), it, done)


@_f32_matmuls
def icp_two_stage_plane(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_normals: jnp.ndarray,
    scene_valid: jnp.ndarray,
    coarse_iterations: int = 150,
    coarse_corr_dist: float = 0.05,
    coarse_rejection: float = 0.02,
    transform_epsilon: float = 1e-5,
    fine_iterations: int = 20,
    fine_corr_dist: float = 0.01,
    fine_rejection: float = 0.01,
) -> ICPResult:
    """icp_two_stage with the point-to-plane update (same schedule)."""
    r1 = icp_plane(
        model_pts, model_valid, scene_pts, scene_normals, scene_valid,
        max_iterations=coarse_iterations, max_corr_dist=coarse_corr_dist,
        rejection_dist=coarse_rejection, transform_epsilon=transform_epsilon,
    )
    moved = model_pts @ r1.transform[:3, :3].T + r1.transform[:3, 3]
    r2 = icp_plane(
        moved, model_valid, scene_pts, scene_normals, scene_valid,
        max_iterations=fine_iterations, max_corr_dist=fine_corr_dist,
        rejection_dist=fine_rejection, transform_epsilon=transform_epsilon,
    )
    T = r2.transform @ r1.transform
    return ICPResult(T, r2.fitness, r2.num_inliers,
                     r1.iterations + r2.iterations, r1.converged | r2.converged)


def _lm_step(cur: jnp.ndarray, tgt: jnp.ndarray, w: jnp.ndarray, lam: jnp.ndarray):
    """One Levenberg-Marquardt solve on the point-to-point objective,
    linearized about the identity with a twist (omega, t):
        r_i = (cur_i + omega x cur_i + t) - tgt_i
    Returns (delta (4,4), predicted new cost, J^T J condition scalars)."""
    r = cur - tgt  # (N, 3)
    # Jacobian blocks: dr/domega = -[cur]_x, dr/dt = I.
    zeros = jnp.zeros_like(cur[:, 0])
    cx = jnp.stack(
        [
            jnp.stack([zeros, cur[:, 2], -cur[:, 1]], axis=1),
            jnp.stack([-cur[:, 2], zeros, cur[:, 0]], axis=1),
            jnp.stack([cur[:, 1], -cur[:, 0], zeros], axis=1),
        ],
        axis=1,
    )  # (N, 3, 3) = -[cur]_x rows
    J = jnp.concatenate([cx, jnp.broadcast_to(jnp.eye(3), cx.shape)], axis=2)  # (N,3,6)
    Jw = J * w[:, None, None]
    JtJ = jnp.einsum("nij,nik->jk", Jw, J)
    Jtr = jnp.einsum("nij,ni->j", Jw, r)
    A = JtJ + lam * jnp.diag(jnp.diag(JtJ)) + 1e-9 * jnp.eye(6)
    delta = -jnp.linalg.solve(A, Jtr)
    omega, t = delta[:3], delta[3:]
    # Exponentiate the rotation (Rodrigues).
    th = jnp.linalg.norm(omega) + 1e-12
    k = omega / th
    K = jnp.array(
        [[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]]
    )
    R = jnp.eye(3) + jnp.sin(th) * K + (1.0 - jnp.cos(th)) * (K @ K)
    T = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)
    return T


@partial(jax.jit, static_argnames=("max_iterations", "lm_iterations"))
@_f32_matmuls
def icp_lm(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_valid: jnp.ndarray,
    max_iterations: int = 50,
    max_corr_dist: float = 0.05,
    rejection_dist: float = 0.02,
    transform_epsilon: float = 1e-8,
    lm_iterations: int = 3,
) -> ICPResult:
    """Levenberg-Marquardt ICP — pcl::IterativeClosestPointNonLinear
    (rgbdDetector.cpp:1546-1553): per correspondence set, a damped
    Gauss-Newton solve on the point-to-point objective with multiplicative
    lambda adaptation (accept halves lambda, reject multiplies by 10),
    instead of the closed-form Kabsch update.  Correspondence gating
    follows PCL: nearest neighbour within max_corr_dist, then residuals
    beyond the RANSAC outlier threshold are rejected.
    """
    corr2 = max_corr_dist * max_corr_dist
    rej2 = rejection_dist * rejection_dist
    scene_safe = jnp.where(scene_valid[:, None], scene_pts, 1e6)

    def cost_of(T, cur, tgt, w):
        moved = cur @ T[:3, :3].T + T[:3, 3]
        return jnp.sum(jnp.sum((moved - tgt) ** 2, axis=1) * w) / jnp.maximum(
            jnp.sum(w), 1.0
        )

    def cond(state):
        T, it, done, _, _, lam = state
        return (it < max_iterations) & (~done)

    def body(state):
        T, it, _, _, _, lam = state
        cur = model_pts @ T[:3, :3].T + T[:3, 3]
        d2 = pairwise_sq_dists(cur, scene_safe)
        nn = jnp.argmin(d2, axis=1)
        nd2 = jnp.min(d2, axis=1)
        # PCL-style two-stage gate: corr-dist first, then RANSAC rejection.
        w = (model_valid & (nd2 < corr2) & (nd2 < rej2)).astype(jnp.float32)
        tgt = scene_safe[nn]

        def lm_body(carry, _):
            # Accepted steps COMPOSE and re-linearize (PCL's LM inner loop):
            # each solve is about the current best transform T_lm, the
            # candidate is delta @ T_lm, and the accept test compares true
            # costs of composed transforms — not repeats of one stale solve.
            T_lm, lam_c, cost_c = carry
            cur_lm = cur @ T_lm[:3, :3].T + T_lm[:3, 3]
            step = _lm_step(cur_lm, tgt, w, lam_c)
            T_cand = step @ T_lm
            new_cost = cost_of(T_cand, cur, tgt, w)
            accept = new_cost < cost_c
            T_n = jnp.where(accept, T_cand, T_lm)
            lam_n = jnp.where(accept, lam_c * 0.5, lam_c * 10.0)
            return (T_n, lam_n, jnp.minimum(new_cost, cost_c)), None

        cost0 = cost_of(jnp.eye(4), cur, tgt, w)
        (delta, lam_f, _), _ = jax.lax.scan(
            lm_body, (jnp.eye(4), lam, cost0), None, length=lm_iterations
        )
        Tn = delta @ T
        dr = jnp.sum((delta[:3, :3] - jnp.eye(3)) ** 2)
        dt = jnp.sum(delta[:3, 3] ** 2)
        done = (dr + dt) < transform_epsilon
        fit = jnp.sum(nd2 * w) / jnp.maximum(jnp.sum(w), 1.0)
        return (Tn, it + 1, done, fit, jnp.sum(w), lam_f)

    state = (
        jnp.eye(4), jnp.int32(0), jnp.array(False),
        jnp.array(jnp.inf), jnp.array(0.0), jnp.array(1e-3),
    )
    T, it, done, fit, ninl, _ = jax.lax.while_loop(cond, body, state)
    return ICPResult(T, fit, ninl.astype(jnp.int32), it, done)


@_f32_matmuls
def icp_nonlinear_schedule(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_valid: jnp.ndarray,
) -> ICPResult:
    """The reference's icpNonLinearPoseRefine 3-pass schedule
    (rgbdDetector.cpp:1546-1597): LM ICP at (50 it, corr 0.05, RANSAC 0.02,
    eps 1e-8) -> (20, 0.02, 0.01) -> (10, 0.005, 0.01), pose composed
    tf @ pose after each pass."""
    stages = ((50, 0.05, 0.02), (20, 0.02, 0.01), (10, 0.005, 0.01))
    T_acc = jnp.eye(4)
    pts = model_pts
    fit = jnp.array(jnp.inf)
    ninl = jnp.array(0, jnp.int32)
    iters = jnp.array(0, jnp.int32)
    conv = jnp.array(False)
    for max_it, corr, rej in stages:
        r = icp_lm(
            pts, model_valid, scene_pts, scene_valid,
            max_iterations=max_it, max_corr_dist=corr, rejection_dist=rej,
        )
        pts = pts @ r.transform[:3, :3].T + r.transform[:3, 3]
        T_acc = r.transform @ T_acc
        fit, ninl, conv = r.fitness, r.num_inliers, conv | r.converged
        iters = iters + r.iterations
    return ICPResult(T_acc, fit, ninl, iters, conv)


@_f32_matmuls
def icp_two_stage(
    model_pts: jnp.ndarray,
    model_valid: jnp.ndarray,
    scene_pts: jnp.ndarray,
    scene_valid: jnp.ndarray,
    coarse_iterations: int = 150,
    coarse_corr_dist: float = 0.05,
    coarse_rejection: float = 0.02,
    transform_epsilon: float = 1e-5,
    fine_iterations: int = 20,
    fine_corr_dist: float = 0.01,
    fine_rejection: float = 0.01,
) -> ICPResult:
    """The reference's coarse + fine-1 ICP schedule (rgbdDetector.cpp:
    1314-1331 then 1349-1368); the composed source->target transform."""
    r1 = icp(
        model_pts, model_valid, scene_pts, scene_valid,
        max_iterations=coarse_iterations,
        max_corr_dist=coarse_corr_dist,
        rejection_dist=coarse_rejection,
        transform_epsilon=transform_epsilon,
    )
    moved = model_pts @ r1.transform[:3, :3].T + r1.transform[:3, 3]
    r2 = icp(
        moved, model_valid, scene_pts, scene_valid,
        max_iterations=fine_iterations,
        max_corr_dist=fine_corr_dist,
        rejection_dist=fine_rejection,
        transform_epsilon=1e-6,
    )
    T = r2.transform @ r1.transform
    return ICPResult(T, r2.fitness, r2.num_inliers, r1.iterations + r2.iterations,
                     r1.converged | r2.converged)
