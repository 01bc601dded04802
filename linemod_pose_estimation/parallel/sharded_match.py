"""Multi-chip template matching: bank-sharded scoring + all-gather top-k merge.

The load-bearing parallelism for large banks (SURVEY.md section 2.3): the
template axis shards over the mesh's "bank" axis (each chip scores its
templates over the whole frame — the TP analog), frames batch over "data"
(DP analog).  This replaces the reference's single-core sliding window +
ROS process pipelining with XLA collectives.

Two entry points:

- make_sharded_coarse_matcher: coarse-level scoring only, using the
  gather-based reference scorer (bit-identical baseline used by equality
  tests).
- make_sharded_detect_step: the PRODUCTION path — per-device preprocess of
  the local frame shard, ONE int8 GEMM per device over its bank shard
  (ops.match.coarse_scores_gemm, the same engine as single-device),
  per-shard top-k, per-shard LEVEL-0 REFINEMENT of its own candidates
  (each device owns its shard's level-0 features, so refinement needs no
  feature exchange), then an all-gather of refined matches across devices and a
  global top-k.  Scoring compute scales 1/n_bank per chip; the collective
  moves only O(top_k) records per frame.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import match as M


def pad_bank_features(feats: M.LevelFeatures, shards: int) -> M.LevelFeatures:
    """Pad the template axis to a multiple of `shards` (padded templates are
    dead: live=False, count=0, giant size so no position validates)."""
    N = feats.oris.shape[0]
    pad = (-N) % shards
    if pad == 0:
        return feats
    z = lambda a, fill=0: jnp.concatenate(
        [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0
    )
    return M.LevelFeatures(
        offsets=z(feats.offsets),
        oris=z(feats.oris),
        live=z(feats.live, False),
        count=z(feats.count),
        size=z(feats.size, 10**6),
    )


class ShardedBank(NamedTuple):
    """Device-ready bank for the sharded detect step, all sharded on the
    template axis: level-1 GEMM weights in TEMPLATE-MAJOR (N, K_dim) layout
    (position-only pruning keeps the weights static and contracts on K;
    the two-axis mode row-gathers survivors from the same array), the
    cell-level upper-bound weights (N, C*Kc^2) for coarse pruning, the
    subcell fine-bound weights (N, C*(Kc*T/g)^2) for the second pruning
    stage, and both levels' features."""

    W1_rows: jnp.ndarray
    W_cell: jnp.ndarray
    W_fine: jnp.ndarray
    feats1: M.LevelFeatures
    feats0: M.LevelFeatures


def _effective_fine_g(T1: int, fine_g: int | None) -> int | None:
    """The fine stage needs g | T1; None (or an indivisible g) disables it.
    make_sharded_bank and make_sharded_detect_step must agree on this —
    both route through here, and the step validates the bank's W_fine
    width against its own g at build time."""
    return fine_g if fine_g and T1 % fine_g == 0 else None


def make_sharded_bank(
    mesh: Mesh, feats1: M.LevelFeatures, feats0: M.LevelFeatures, C: int,
    T1: int, Kc1: int, fine_g: int | None = 4,
) -> ShardedBank:
    """Pad + place a bank with its multi-chip shardings (template axis over
    "bank"; the GEMM weight's N axis likewise).  With fine_g disabled (None
    or not dividing T1), W_fine is a zero-width placeholder and the step
    runs coarse-only pruning."""
    n_bank = mesh.shape["bank"]
    feats1 = pad_bank_features(feats1, n_bank)
    feats0 = pad_bank_features(feats0, n_bank)
    W1_rows = M.build_gemm_weights(feats1, C, T1, Kc1).T
    W_cell = M.build_cell_weights(feats1, C, T1, Kc1)
    g = _effective_fine_g(T1, fine_g)
    W_fine = (M.build_cell_weights_fine(feats1, C, T1, Kc1, g) if g
              else jnp.zeros((feats1.oris.shape[0], 0), jnp.int8))
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    return ShardedBank(
        W1_rows=put(W1_rows, P("bank", None)),
        W_cell=put(W_cell, P("bank", None)),
        W_fine=put(W_fine, P("bank", None)),
        feats1=jax.tree.map(lambda a: put(a, P("bank")), feats1),
        feats0=jax.tree.map(lambda a: put(a, P("bank")), feats0),
    )


def _merge_topk(mat: M.Matches, top_k: int, threshold: float, axis: str) -> M.Matches:
    """All-gather per-shard refined matches across devices, keep the global top-k."""
    allm = jax.lax.all_gather(mat, axis, axis=1, tiled=False)
    sims = allm.similarity.reshape(allm.similarity.shape[0], -1)
    vals, idx = jax.lax.top_k(jnp.where(allm.valid.reshape(sims.shape), sims, -1.0), top_k)
    take = lambda a: jnp.take_along_axis(a.reshape(sims.shape), idx, axis=1)
    return M.Matches(
        template_id=take(allm.template_id),
        x=take(allm.x),
        y=take(allm.y),
        similarity=vals,
        valid=take(allm.valid) & (vals >= threshold),
    )


def make_sharded_coarse_matcher(
    mesh: Mesh,
    T: int,
    max_cell_extent: int,
    top_k: int,
    threshold: float,
):
    """Coarse-only matcher on the gather-based reference scorer.

    R_batch: (B, C, H, W) response maps, B sharded over "data".
    feats:   LevelFeatures with template axis sharded over "bank".
    Output:  per-frame global top-k (B, top_k) arrays, replicated over
             "bank", sharded over "data".
    """
    feats_spec = M.LevelFeatures(
        offsets=P("bank"), oris=P("bank"), live=P("bank"), count=P("bank"), size=P("bank")
    )

    def local_match(R_local, feats_local):
        def one_frame(R):
            raw = M.coarse_scores(R, feats_local, T, max_cell_extent)
            Hc, Wc = raw.shape[1:]
            vpos = M.position_validity(feats_local.size, T, Hc, Wc)
            cand = M.select_candidates(raw, feats_local.count, vpos, threshold, top_k)
            # Re-base template ids to global indices.
            shard = jax.lax.axis_index("bank")
            n_local = feats_local.oris.shape[0]
            gtid = cand.template_id + shard.astype(jnp.int32) * n_local
            return M.CoarseMatches(gtid, cand.cell_y, cand.cell_x, cand.similarity, cand.valid)

        cand = jax.vmap(one_frame)(R_local)

        # Merge shards: all-gather per-shard top-k across devices, then global top-k.
        allc = jax.lax.all_gather(cand, "bank", axis=1, tiled=False)
        sims = allc.similarity.reshape(allc.similarity.shape[0], -1)
        vals, idx = jax.lax.top_k(jnp.where(
            allc.valid.reshape(sims.shape), sims, -1.0), top_k)
        take = lambda a: jnp.take_along_axis(a.reshape(sims.shape), idx, axis=1)
        return M.CoarseMatches(
            template_id=take(allc.template_id),
            cell_y=take(allc.cell_y),
            cell_x=take(allc.cell_x),
            similarity=vals,
            valid=take(allc.valid) & (vals >= threshold),
        )

    fn = shard_map(
        local_match,
        mesh=mesh,
        in_specs=(P("data"), feats_spec),
        out_specs=M.CoarseMatches(
            template_id=P("data"), cell_y=P("data"), cell_x=P("data"),
            similarity=P("data"), valid=P("data"),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


def make_row_sharded_matcher(
    mesh: Mesh,
    axis: str,
    T1: int,
    Kc1: int,
    top_k: int,
    threshold: float,
    T0: int = 5,
    E0: int = 96,
    coarse_margin: float = 5.0,
):
    """Image-plane (sequence/context-parallel analog, SURVEY.md section 2.3):
    shard the FRAME's rows over `axis` instead of the template bank — the
    right layout for single-frame latency on very large frames, where the
    position axis dwarfs the bank.

    Each device scores the window positions whose anchor row falls in its
    row stripe.  A template window extends T1*Kc1 rows past its anchor at
    the coarse level (and E0+window rows at level 0), so each device pulls
    that HALO from its lower neighbour with ONE `ppermute` across devices before
    scoring — the classic context-parallel halo exchange.  Per-shard top-k
    then refinement on local rows, all-gather merge, identical results to
    the single-device engine.

    Inputs to the returned fn: R1 (C, H1, W1) and R0 (C, H0, W0) response
    stacks sharded on their row axis [P(None, axis)], plus the REPLICATED
    bank (W1 GEMM weights, feats1, feats0).  H1 must divide by
    n_shards * T1.
    """
    n = mesh.shape[axis]
    halo1 = T1 * Kc1  # coarse-level rows a window may read past its anchor
    # Level-0 walk reach (cv::linemod local refinement): the window starts
    # up to 8*T0 rows ABOVE the clamped anchor (plus up to E0 more when the
    # bottom-border clamp pulls the anchor up) and ends 15*T0 + T0-1 + E0
    # rows below it; halos rounded to multiples of T0 so the stride-T0
    # reshape in the walk stays phase-aligned across the stripe seam.
    UP = -(-(8 * T0 + E0) // T0) * T0
    halo0 = -(-(16 * T0 + E0) // T0) * T0              # downward reach

    def local_match(R1_loc, R0_loc, W1, feats1, feats0):
        # R1_loc: (C, H1/n, W1); R0_loc: (C, H0/n, W0)
        assert R0_loc.shape[1] % T0 == 0, (
            "row stripes must be multiples of T0: the walk's stride-T0 "
            "placement grid is phase-locked to global rows, so each "
            "stripe's y_origin must land on the grid "
            f"(H0/n = {R0_loc.shape[1]}, T0 = {T0})"
        )
        assert R1_loc.shape[1] % T1 == 0, (
            "row stripes must be multiples of T1 at level 1: anchor cells "
            "are phase-locked to the GLOBAL T1 grid, and the global-cell "
            "re-base idx * (H1/n // T1) floors otherwise — positions "
            "would silently shift vs the single-device engine "
            f"(H1/n = {R1_loc.shape[1]}, T1 = {T1}; level-0 stripes must "
            f"be multiples of lcm(2*T1, T0))"
        )
        idx = jax.lax.axis_index(axis)

        def pull_next_rows(X, rows):
            """Rows immediately BELOW this stripe (multi-hop ppermute when
            the halo exceeds one stripe); zeros past the frame bottom."""
            parts, h, left = [], 1, rows
            while left > 0:
                take = min(left, X.shape[1])
                perm = [(i, (i - h) % n) for i in range(n)]
                nb = jax.lax.ppermute(X[:, :take, :], axis, perm)
                parts.append(jnp.where(idx + h < n, nb, jnp.zeros_like(nb)))
                left -= take
                h += 1
            return jnp.concatenate(parts, axis=1)

        def pull_prev_rows(X, rows):
            """Rows immediately ABOVE this stripe; zeros above the top."""
            parts, h, left = [], 1, rows
            while left > 0:
                take = min(left, X.shape[1])
                perm = [(i, (i + h) % n) for i in range(n)]
                nb = jax.lax.ppermute(X[:, -take:, :], axis, perm)
                parts.insert(0, jnp.where(idx - h >= 0, nb,
                                          jnp.zeros_like(nb)))
                left -= take
                h += 1
            return jnp.concatenate(parts, axis=1)

        R1x = jnp.concatenate(
            [R1_loc, pull_next_rows(R1_loc, halo1)], axis=1
        )
        R0x = jnp.concatenate(
            [pull_prev_rows(R0_loc, UP), R0_loc,
             pull_next_rows(R0_loc, halo0)], axis=1,
        )

        Hc_loc = R1_loc.shape[1] // T1  # anchor cells owned by this shard
        raw = M.coarse_scores_gemm(R1x, W1, T1, Kc1)[:, :Hc_loc, :]
        Hc, Wc = raw.shape[1:]
        # Validity vs the GLOBAL image height: row offset re-based.
        row0_cells = idx * Hc_loc
        ii = jax.lax.broadcasted_iota(jnp.int32, (Hc, Wc), 0) + row0_cells
        jj = jax.lax.broadcasted_iota(jnp.int32, (Hc, Wc), 1)
        h = feats1.size[:, 0][:, None, None]
        w = feats1.size[:, 1][:, None, None]
        H1_tot = R1_loc.shape[1] * n
        vpos = (ii[None] * T1 + h <= H1_tot) & (jj[None] * T1 + w <= Wc * T1)
        cand = M.select_candidates(
            raw, feats1.count, vpos, max(threshold - coarse_margin, 0.0), top_k
        )
        # The walk runs in GLOBAL coordinates: candidates carry global cell
        # rows, `total_hw` clamps against the global frame borders, and
        # `y_origin` maps the stripe-local R0x rows back to global ones.
        H0_loc = R0_loc.shape[1]
        cand_gl = M.CoarseMatches(
            cand.template_id,
            cand.cell_y + idx * (H0_loc // (2 * T1)),
            cand.cell_x,
            cand.similarity, cand.valid,
        )
        ref_b = M.refine_candidates_opencv_batched(
            R0x[None], feats0, M.CoarseMatches(*(a[None] for a in cand_gl)),
            T1, threshold, E0=E0, fine_T=T0,
            total_hw=(H0_loc * n, R0_loc.shape[2]),
            y_origin=idx * H0_loc - UP,
        )
        ref = M.Matches(*(a[0] for a in ref_b))
        merged = _merge_topk(
            M.Matches(*(a[None] for a in ref)), top_k, threshold, axis
        )
        return M.Matches(*(a[0] for a in merged))

    fn = shard_map(
        local_match,
        mesh=mesh,
        in_specs=(
            P(None, axis), P(None, axis), P(),
            M.LevelFeatures(P(), P(), P(), P(), P()),
            M.LevelFeatures(P(), P(), P(), P(), P()),
        ),
        out_specs=M.Matches(
            template_id=P(), x=P(), y=P(), similarity=P(), valid=P()
        ),
        check_vma=False,
    )
    return jax.jit(fn)


class RingBank(NamedTuple):
    """Bank layout for the ring-rotation step: level-1 GEMM weights in the
    contraction-ready (K_dim, N) layout with N sharded over the ring axis,
    plus both feature levels (template axis sharded the same way)."""

    W1: jnp.ndarray
    feats1: M.LevelFeatures
    feats0: M.LevelFeatures


def make_ring_bank(
    mesh: Mesh, axis: str, feats1: M.LevelFeatures, feats0: M.LevelFeatures,
    C: int, T1: int, Kc1: int,
) -> RingBank:
    n = mesh.shape[axis]
    feats1 = pad_bank_features(feats1, n)
    feats0 = pad_bank_features(feats0, n)
    W1 = M.build_gemm_weights(feats1, C, T1, Kc1)  # (K, N)
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    return RingBank(
        W1=put(W1, P(None, axis)),
        feats1=jax.tree.map(lambda a: put(a, P(axis)), feats1),
        feats0=jax.tree.map(lambda a: put(a, P(axis)), feats0),
    )


def make_ring_detect_step(
    mesh: Mesh,
    axis: str,
    T1: int,
    Kc1: int,
    top_k: int,
    threshold: float,
    T0: int = 5,
    E0: int = 96,
    use_depth: bool = False,
    coarse_margin: float = 5.0,
    weak_threshold: float = 10.0,
):
    """Ring-pipelined bank rotation (SURVEY.md §5 scale-axis note: "rotate
    template shards around devices while frames stream" — the moral
    equivalent of ring attention / context-parallel pipelining).

    Layout: frames are DATA-parallel over the single `axis` (each device
    owns B/n frames and preprocesses them ONCE); the bank is sharded 1/n
    per device and ROTATES: at step t, device d scores its own frames
    against shard (d - t) mod n, refines the step's candidates with that
    shard's level-0 features (still local — features rotate with the
    weights), folds them into a running top-k, and `ppermute`s the shard
    to its ring neighbour.  After n steps every frame has met every
    template with NO all-gather of scores and NO frame replication; XLA's
    async collective-permute lets the next shard stream across devices while the
    current GEMM runs, so the wire hides behind compute.

    vs the static bank-TP step (make_sharded_detect_step): static TP
    replicates every FRAME to all devices (B*H*W bytes broadcast per batch)
    and all-gathers per-shard matches; the ring moves WEIGHT shards
    (n-1 ppermute hops of |W|/n each, total |W| per batch) and nothing
    else.  The ring wins when frames outweigh the bank per batch —
    B*frame_bytes > |W| — i.e. large batches or small banks; static TP
    wins for huge banks at small batch.

    Inputs: rgbs (B, H, W, 3) u8 [P(axis)], depths (B, H, W) f32,
    bank: RingBank (make_ring_bank).  Output: Matches (B, top_k) [P(axis)],
    identical (as a valid-set) to the single-device engine.
    """
    n = mesh.shape[axis]
    feats_spec = M.LevelFeatures(
        offsets=P(axis), oris=P(axis), live=P(axis), count=P(axis), size=P(axis)
    )
    bank_spec = RingBank(W1=P(None, axis), feats1=feats_spec, feats0=feats_spec)
    sel_thr = max(threshold - coarse_margin, 0.0)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def local_step(rgbs, depths, bank):
        n_local = bank.feats1.oris.shape[0]
        d = jax.lax.axis_index(axis).astype(jnp.int32)

        def pre(rgb, depth):
            pyr = M.preprocess_frame(
                rgb, depth, T0=T0, T1=T1, use_depth=use_depth,
                weak_threshold=weak_threshold,
            )
            return M.stack_modalities(pyr, use_depth)

        R0, R1 = jax.vmap(pre)(rgbs, depths)
        B_loc = R1.shape[0]
        Hc, Wc = R1.shape[2] // T1, R1.shape[3] // T1

        best = M.Matches(
            template_id=jnp.zeros((B_loc, top_k), jnp.int32),
            x=jnp.zeros((B_loc, top_k), jnp.int32),
            y=jnp.zeros((B_loc, top_k), jnp.int32),
            similarity=jnp.full((B_loc, top_k), -1.0, jnp.float32),
            valid=jnp.zeros((B_loc, top_k), bool),
        )
        W1, feats1, feats0 = bank.W1, bank.feats1, bank.feats0
        for t in range(n):
            # Kick the NEXT shard onto the wire first: XLA's async
            # collective-permute overlaps the hop with this step's GEMM.
            if t + 1 < n:
                nxt = jax.tree.map(
                    lambda a: jax.lax.ppermute(a, axis, perm),
                    (W1, feats1, feats0),
                )
            vpos = M.position_validity_flat(feats1.size, T1, Hc, Wc)
            raw = M.coarse_scores_gemm_flat_batched(R1, W1, T1, Kc1)
            cand = jax.vmap(
                lambda r: M.select_candidates_flat(
                    r, feats1.count, vpos, sel_thr, top_k, Wc
                )
            )(raw)
            ref = M.refine_candidates_opencv_batched(
                R0, feats0, cand, T1, threshold, E0=E0, fine_T=T0,
            )
            shard_id = jnp.mod(d - t, n)  # which shard this device holds now
            cat = lambda a, b: jnp.concatenate([a, b], axis=1)
            sims = cat(best.similarity, ref.similarity)
            vals, idx = jax.lax.top_k(
                jnp.where(cat(best.valid, ref.valid), sims, -1.0), top_k
            )
            take = lambda a, b: jnp.take_along_axis(cat(a, b), idx, axis=1)
            best = M.Matches(
                template_id=take(
                    best.template_id, ref.template_id + shard_id * n_local
                ),
                x=take(best.x, ref.x),
                y=take(best.y, ref.y),
                similarity=vals,
                valid=take(best.valid, ref.valid) & (vals >= threshold),
            )
            if t + 1 < n:
                W1, feats1, feats0 = nxt
        return best

    out_spec = M.Matches(
        template_id=P(axis), x=P(axis), y=P(axis),
        similarity=P(axis), valid=P(axis),
    )
    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), bank_spec),
        out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_detect_step(
    mesh: Mesh,
    T1: int,
    Kc1: int,
    top_k: int,
    threshold: float,
    T0: int = 5,
    E0: int = 96,
    use_depth: bool = False,
    coarse_margin: float = 5.0,
    weak_threshold: float = 10.0,
    prune: bool = True,
    prune_cap: int = 1024,
    prune_pos_cap: int = 256,
    prune_mode: str = "positions",
    fine_g: int | None = 4,
    fine_pos_cap: int | None = None,
    pool_coarse: int | None = None,
    pool_fine: int | None = None,
    sel_row_cap: int = 128,
):
    """The full multi-chip detect step over a raw frame batch:

      rgbs (B, H, W, 3) u8 [P("data")], depths (B, H, W) f32 or None
      bank: ShardedBank (make_sharded_bank)
      -> Matches with (B, top_k) arrays [P("data")], metrics psum'd over
         the whole mesh.

    Per device, the SAME kernels as the single-chip production path
    (models/serving.BatchedMatcher): preprocess its local frames, the
    hierarchical-pruning upper-bound GEMM + two-axis survivor compaction
    over its bank shard (prune=False: the exhaustive batched int8 GEMM),
    position-major flat candidate select, ONE refinement-walk dispatch
    over all local B*top_k candidates, then an all-gather + global
    top-k.  Pruning composes with bank-TP for free:
    the bound and compaction are shard-local, so no extra collectives —
    each chip prunes its own shard and the wire still carries O(top_k)
    records.  This is the function the driver dry-runs across virtual
    devices (__graft_entry__.dryrun_multichip).
    """
    feats_spec = M.LevelFeatures(
        offsets=P("bank"), oris=P("bank"), live=P("bank"), count=P("bank"), size=P("bank")
    )
    bank_spec = ShardedBank(
        W1_rows=P("bank", None), W_cell=P("bank", None),
        W_fine=P("bank", None),
        feats1=feats_spec, feats0=feats_spec,
    )
    sel_thr = max(threshold - coarse_margin, 0.0)
    fine_g = _effective_fine_g(T1, fine_g)
    m2_cap = M._default_cap(fine_pos_cap, prune_pos_cap, "fine_pos_cap")
    if fine_g:
        # Catch a bank built with a DIFFERENT g (or fine disabled) at
        # build time instead of a shape error mid-trace.  C_eff mirrors
        # make_sharded_bank's modality channel count (8 per modality).
        C_eff = 16 if use_depth else 8
        exp_cols = (Kc1 * T1 // fine_g) ** 2 * C_eff

    def local_step(rgbs, depths, bank):
        n_local = bank.feats1.oris.shape[0]
        shard = jax.lax.axis_index("bank").astype(jnp.int32)

        def pre(rgb, depth):
            pyr = M.preprocess_frame(
                rgb, depth, T0=T0, T1=T1, use_depth=use_depth,
                weak_threshold=weak_threshold,
            )
            return M.stack_modalities(pyr, use_depth)

        R0, R1 = jax.vmap(pre)(rgbs, depths)
        Hc, Wc = R1.shape[2] // T1, R1.shape[3] // T1
        vpos = M.position_validity_flat(bank.feats1.size, T1, Hc, Wc)
        nv = None

        if prune and prune_mode == "pooled":
            # The PRODUCTION single-chip mode, shard-local: one batch-
            # shared survivor pool per device over its local frames and
            # bank shard (pool capacity scales with the LOCAL batch).  No
            # collectives in any branch, so shards overflow/fall back
            # independently.
            if not fine_g:
                raise ValueError("prune_mode='pooled' requires fine_g")
            if bank.W_fine.shape[1] != exp_cols:
                raise ValueError(
                    f"bank W_fine has {bank.W_fine.shape[1]} columns but "
                    f"this step's fine_g={fine_g} needs {exp_cols} "
                    f"(C={C_eff} for use_depth={use_depth})"
                )
            B_loc = R1.shape[0]
            p1 = pool_coarse if pool_coarse is not None else 64 * B_loc
            p2 = pool_fine if pool_fine is not None else 32 * B_loc
            cand, nv, _stats = M.match_pooled_fine_with_fallback(
                R1, bank.W1_rows.T, bank.W_cell, bank.W_fine,
                bank.feats1.count, vpos, sel_thr, T1, Kc1, fine_g,
                p1, p2, top_k, Wc, r_cap=sel_row_cap,
            )
            n_fallback = _stats.fallback.astype(jnp.int32)
        elif prune and prune_mode == "positions" and fine_g:
            # Two-stage position pruning (the single-chip production
            # mode): coarse cell-max bound, then the g x g subcell
            # re-test, both shard-local; the weight matrix stays static
            # (contract bank.W1_rows on its K axis).  Overflows fall back
            # in-graph per shard — no collectives in any branch, so
            # shards can take different branches freely.
            if bank.W_fine.shape[1] != exp_cols:
                raise ValueError(
                    f"bank W_fine has {bank.W_fine.shape[1]} columns but "
                    f"this step's fine_g={fine_g} needs {exp_cols} "
                    f"(= (Kc1*T1/g)^2 * C with Kc1={Kc1}, T1={T1}, "
                    f"C={C_eff} from use_depth={use_depth}): build the "
                    "bank and the step with the SAME fine_g AND C "
                    "(make_sharded_bank(fine_g=..., C=...), or "
                    "fine_g=None on both to disable the fine stage)"
                )
            cand, _plan, _fine = M.match_coarse_pruned_fine_with_fallback(
                R1, bank.W1_rows.T, bank.W_cell, bank.W_fine,
                bank.feats1.count, vpos, sel_thr, T1, Kc1, fine_g,
                prune_pos_cap, m2_cap, top_k, Wc,
            )
            n_fallback = (_plan.overflow | _fine.overflow).astype(jnp.int32)
        elif prune and prune_mode == "positions":
            cand, _plan = M.match_coarse_pruned_with_fallback(
                R1, bank.W1_rows.T, bank.W_cell, bank.feats1.count, vpos,
                sel_thr, T1, Kc1, prune_pos_cap, top_k, Wc,
            )
            n_fallback = _plan.overflow.astype(jnp.int32)
        elif prune:
            plan = M.prune_plan_batched(
                R1, bank.W_cell, bank.feats1.count, vpos, sel_thr, T1, Kc1,
                min(prune_cap, n_local), prune_pos_cap,
            )
            raw_sub = M.coarse_scores_gemm_flat_batched_sub2(
                R1, bank.W1_rows, plan.t_idx, plan.p_idx, T1, Kc1
            )
            cand = jax.vmap(
                lambda raw, pi, pk: M.select_candidates_flat_sub2(
                    raw, bank.feats1.count, vpos, plan.t_idx, plan.t_keep,
                    pi, pk, sel_thr, top_k, Wc,
                )
            )(raw_sub, plan.p_idx, plan.p_keep)
            n_fallback = plan.overflow.astype(jnp.int32)
        else:
            raw = M.coarse_scores_gemm_flat_batched(R1, bank.W1_rows.T, T1, Kc1)
            cand = jax.vmap(
                lambda r: M.select_candidates_flat(
                    r, bank.feats1.count, vpos, sel_thr, top_k, Wc
                )
            )(raw)
            n_fallback = jnp.int32(0)

        ref = M.refine_candidates_opencv_batched(
            R0, bank.feats0, cand, T1, threshold, E0=E0, fine_T=T0,
            n_valid=nv,
        )
        mat = M.Matches(
            template_id=ref.template_id + shard * n_local,
            x=ref.x, y=ref.y, similarity=ref.similarity, valid=ref.valid,
        )
        merged = _merge_topk(mat, top_k, threshold, "bank")
        num = jax.lax.psum(
            jnp.sum(merged.valid.astype(jnp.int32)), ("data", "bank")
        ) // mesh.shape["bank"]
        best = jax.lax.pmax(
            jnp.max(jnp.where(merged.valid, merged.similarity, -1.0)), ("data", "bank")
        )
        # Shards that took an in-graph fallback this step (results stay
        # exact either way — this surfaces the capacity pressure that
        # used to live only in shard-local plans).
        fb = jax.lax.psum(n_fallback, ("data", "bank"))
        return merged, {"num_matches": num, "best_similarity": best,
                        "prune_fallback_shards": fb}

    out_spec = M.Matches(
        template_id=P("data"), x=P("data"), y=P("data"),
        similarity=P("data"), valid=P("data"),
    )
    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("data"), P("data"), bank_spec),
        out_specs=(out_spec, {"num_matches": P(), "best_similarity": P(),
                              "prune_fallback_shards": P()}),
        check_vma=False,
    )
    return jax.jit(fn)
