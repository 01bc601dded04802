"""Batched multi-camera serving: the reference's "one ROS callback at a
time" becomes data-parallel frame batches (SURVEY.md §2.3 DP analog).

BatchedMatcher runs B frames through the match engine per step:
preprocess vmapped over the batch (dual-modality RGB-D supported), ONE
coarse int8 GEMM with the frame batch folded into the M dimension
(coarse_scores_gemm_flat_batched), position-major candidate selection,
and ONE refinement-walk dispatch over all B*top_k candidates (each
candidate reads its own frame's response maps).

Also the carmine node's extras (SURVEY.md C17):
- look_at_point: cloud point at a detection's bbox center with
  nearest-valid fallback (get_look_at_point, carmine:654-671).
- template_refinement: re-render at the estimated pose and re-run ICP
  (templateRefinement, carmine:555-652).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import match as M
from ..utils import pointcloud as pcu
from ..ops.icp import icp_two_stage


class BatchedMatcher:
    """`prune=True` turns on the exact hierarchical pruning pass
    (ops.match upper-bound GEMM + two-axis survivor compaction): the
    expensive coarse GEMM runs over at most `prune_cap` templates x
    `prune_pos_cap` window positions whose cell-max upper bound reaches
    the selection threshold.  Exactness: every candidate at or above
    `threshold - 5` survives; in the default "positions" mode an IN-GRAPH
    lax.cond falls back to the exhaustive GEMM whenever survivor positions
    overflow `prune_pos_cap`, so results are UNCONDITIONALLY exact (the
    reference engine scores every position — rgbdDetector.cpp:31-34).
    `self.last_prune` (a PrunePlan, device-side) reports survivor counts
    and whether the most recent batch took the fallback.

    `fine_g` adds the second pruning stage in "positions" mode: a g x g
    subcell max bound re-tested at the coarse survivors kills the ~40%
    of them (measured on real bin-picking scenes) whose T x T cell-max
    bound was optimistic, compacting to `fine_pos_cap` positions before
    the exact GEMM (which is linear in the position count).  Exactness is
    unchanged — the fine bound still dominates the exact score, and its
    own in-graph fallback re-runs the coarse survivor set on overflow
    (`self.last_fine`, a FinePlan, reports it).  `fine_g=None` disables
    the stage.

    `prune_mode="pooled"` (the PRODUCTION mode) replaces the per-frame
    survivor caps with ONE batch-shared frame-major pool per stage
    (ops.match.match_pooled_fine_with_fallback): a busy frame takes more
    pool slots instead of tripping the whole batch into the fallback, so
    the pools run at ~1.3x the mean survivor count where per-frame caps
    needed ~2x.  `pool_coarse`/`pool_fine` size the two pools (None ->
    64/32 slots per batch frame); `sel_row_cap` bounds the per-frame
    select range (cheap — no GEMM scales with it).  The refinement walk
    additionally skips the sub-threshold top-k filler via the per-frame
    valid-prefix count the pooled select returns.  `self.last_pool` (a
    PooledStats) reports true survivor totals and any fallback."""

    def __init__(self, detector, class_id: str, threshold: float, batch: int,
                 top_k: int = 256, prune: bool = False, prune_cap: int = 1024,
                 prune_pos_cap: int = 256, prune_mode: str = "positions",
                 fine_g: int | None = 4, fine_pos_cap: int | None = None,
                 pool_coarse: int | None = None, pool_fine: int | None = None,
                 sel_row_cap: int = 128, group_bound: int | None = None,
                 pool_group: int | None = None):
        p = detector.params
        bank = detector.bank(class_id)
        self.T0, self.T1 = p.t_pyramid
        self.threshold = threshold
        self.top_k = top_k
        self.batch = batch
        self.W1 = bank.gemm_weights(1)
        self.Kc1 = bank.max_cell_extent(1)
        self.E0 = bank.extent(0)
        self.feats1 = bank.merged_features(1)
        self.feats0 = bank.merged_features(0)
        self.use_depth = p.use_depth_normal
        self.weak = p.color.weak_threshold
        self.prune = prune
        self.prune_mode = prune_mode
        self.prune_cap = min(prune_cap, int(self.feats1.oris.shape[0]))
        self.prune_pos_cap = prune_pos_cap
        self.fine_g = fine_g if self.T1 % (fine_g or 1) == 0 else None
        self.fine_pos_cap = M._default_cap(fine_pos_cap, prune_pos_cap,
                                           "fine_pos_cap")
        self.last_prune = None
        self.last_fine = None
        self.last_pool = None
        self.pool_coarse = pool_coarse if pool_coarse is not None else 64 * batch
        self.pool_fine = pool_fine if pool_fine is not None else 32 * batch
        self.sel_row_cap = sel_row_cap
        self.group_bound = group_bound
        self.pool_group = pool_group if pool_group is not None \
            else 2 * self.pool_coarse
        self.W_fine = None
        self.W_group = self.group_counts = None
        if prune_mode == "pooled" and not self.fine_g:
            raise ValueError("prune_mode='pooled' requires a fine_g that "
                             f"divides T1={self.T1}")
        if prune_mode == "pooled" and not prune:
            # match_batch gates on `prune`; without this a pooled-mode
            # matcher would silently run the exhaustive path.
            raise ValueError("prune_mode='pooled' requires prune=True")
        if prune:
            n_mod = 2 if self.use_depth else 1
            if prune_mode == "two_axis":
                self.W1_rows = jnp.asarray(self.W1).T  # template-major (N, K)
            self.W_cell = M.build_cell_weights(
                self.feats1, 8 * n_mod, self.T1, self.Kc1
            )
            if prune_mode in ("positions", "pooled") and self.fine_g:
                self.W_fine = M.build_cell_weights_fine(
                    self.feats1, 8 * n_mod, self.T1, self.Kc1, self.fine_g
                )
            if prune_mode == "pooled" and group_bound:
                self.W_group, self.group_counts = M.build_group_bound(
                    self.feats1, 8 * n_mod, self.T1, self.Kc1, group_bound,
                    W_cell=self.W_cell,
                )
        self._build()

    def _build(self):
        T0, T1, Kc1, E0 = self.T0, self.T1, self.Kc1, self.E0
        thr, top_k = self.threshold, self.top_k
        use_depth = self.use_depth

        self._pre = jax.jit(lambda rgbs, depths: M.preprocess_frames_batched(
            rgbs, depths, T0=T0, T1=T1, use_depth=use_depth,
            weak_threshold=self.weak))
        # Position-major (Hc*Wc, N) scores, the GEMM's natural layout.
        self._coarse = jax.jit(
            lambda Rb, W: M.coarse_scores_gemm_flat_batched(Rb, W, T1, Kc1)
        )

        def _sel(raw_flat, f1, Hc, Wc):
            vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
            return M.select_candidates_flat(
                raw_flat, f1.count, vpos, thr - 5.0, top_k, Wc
            )

        self._sel = jax.jit(
            jax.vmap(_sel, in_axes=(0, None, None, None)),
            static_argnames=("Hc", "Wc"),
        )
        if self.prune and self.prune_mode == "pooled":
            g = self.fine_g
            p1, p2, rcap = self.pool_coarse, self.pool_fine, self.sel_row_cap
            grp, p0 = self.group_bound, self.pool_group
            Wgr, gcnt = self.W_group, self.group_counts

            def _match_pool(Rb, W_gemm, W_cell, W_fine, f1, Hc, Wc):
                vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
                kw = {}
                if Wgr is not None:
                    kw = dict(W_group=Wgr, group_counts=gcnt, pool0=p0,
                              group=grp)
                return M.match_pooled_fine_with_fallback(
                    Rb, W_gemm, W_cell, W_fine, f1.count, vpos, thr - 5.0,
                    T1, Kc1, g, p1, p2, top_k, Wc, r_cap=rcap, **kw,
                )

            self._match_pool = jax.jit(_match_pool,
                                       static_argnames=("Hc", "Wc"))
        elif self.prune and self.prune_mode == "positions":
            m_cap = self.prune_pos_cap
            g, m2_cap = self.fine_g, self.fine_pos_cap

            if g:
                def _match_fb(Rb, W_gemm, W_cell, W_fine, f1, Hc, Wc):
                    vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
                    cand, pp, fp = M.match_coarse_pruned_fine_with_fallback(
                        Rb, W_gemm, W_cell, W_fine, f1.count, vpos,
                        thr - 5.0, T1, Kc1, g, m_cap, m2_cap, top_k, Wc,
                    )
                    return cand, pp, fp
            else:
                def _match_fb(Rb, W_gemm, W_cell, W_fine, f1, Hc, Wc):
                    vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
                    cand, pp = M.match_coarse_pruned_with_fallback(
                        Rb, W_gemm, W_cell, f1.count, vpos, thr - 5.0, T1,
                        Kc1, m_cap, top_k, Wc,
                    )
                    return cand, pp, None

            self._match_fb = jax.jit(_match_fb, static_argnames=("Hc", "Wc"))
        elif self.prune:
            n_cap, m_cap = self.prune_cap, self.prune_pos_cap

            def _prune(Rb, W_cell, f1, Hc, Wc):
                vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
                return M.prune_plan_batched(
                    Rb, W_cell, f1.count, vpos, thr - 5.0, T1, Kc1, n_cap, m_cap
                )

            self._prune = jax.jit(_prune, static_argnames=("Hc", "Wc"))
            self._coarse_sub = jax.jit(
                lambda Rb, Wr, t_idx, p_idx: M.coarse_scores_gemm_flat_batched_sub2(
                    Rb, Wr, t_idx, p_idx, T1, Kc1
                )
            )

            def _sel_sub(raw_sub, p_idx, p_keep, f1, t_idx, t_keep, Hc, Wc):
                vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
                return M.select_candidates_flat_sub2(
                    raw_sub, f1.count, vpos, t_idx, t_keep, p_idx, p_keep,
                    thr - 5.0, top_k, Wc
                )

            self._sel_sub = jax.jit(
                jax.vmap(_sel_sub, in_axes=(0, 0, 0, None, None, None, None, None)),
                static_argnames=("Hc", "Wc"),
            )
        # cv::linemod's exact local-refinement walk — positions/scores are
        # bit-identical to the genuine engine (walk form: ops.backend).
        self._refine = jax.jit(
            lambda R0, cand, f0: M.refine_candidates_opencv_batched(
                R0, f0, cand, T1, thr, E0=E0, fine_T=T0,
            )
        )
        # Pooled mode's walk: skip the sub-threshold top-k filler slots
        # (the select's per-frame valid-prefix count rides along).
        self._refine_nv = jax.jit(
            lambda R0, cand, f0, nv: M.refine_candidates_opencv_batched(
                R0, f0, cand, T1, thr, E0=E0, fine_T=T0, n_valid=nv,
            )
        )

    def match_batch(
        self, rgbs: jnp.ndarray, depths_mm: jnp.ndarray | None = None
    ) -> M.Matches:
        """(B, H, W, 3) uint8 [+ (B, H, W) depth mm] -> batched Matches with
        (B, top_k) arrays (device-side; mask by .valid)."""
        if self.use_depth and depths_mm is None:
            raise ValueError(
                "this bank uses the DepthNormal modality: match_batch "
                "requires depths_mm (B, H, W) in millimetres"
            )
        if self.use_depth:
            R0, R1 = self._pre(rgbs, depths_mm)
        else:
            R0, R1 = self._pre(rgbs, jnp.zeros(rgbs.shape[:3], jnp.float32))
        Hc, Wc = R1.shape[2] // self.T1, R1.shape[3] // self.T1
        if self.prune and self.prune_mode == "pooled":
            cands, n_valid, stats = self._match_pool(
                R1, self.W1, self.W_cell, self.W_fine, self.feats1, Hc, Wc)
            self.last_pool = stats
            return self._refine_nv(R0, cands, self.feats0, n_valid)
        if self.prune and self.prune_mode == "positions":
            # One fused program: prune -> fine re-test -> lax.cond
            # (overflow: coarse survivors / exhaustive) -> select.
            # Unconditionally exact.
            cands, pr, fn = self._match_fb(
                R1, self.W1, self.W_cell, self.W_fine, self.feats1, Hc, Wc)
            self.last_prune = pr
            self.last_fine = fn
        elif self.prune:
            pr = self._prune(R1, self.W_cell, self.feats1, Hc, Wc)
            self.last_prune = pr
            raw_sub = self._coarse_sub(R1, self.W1_rows, pr.t_idx, pr.p_idx)
            cands = self._sel_sub(raw_sub, pr.p_idx, pr.p_keep, self.feats1,
                                  pr.t_idx, pr.t_keep, Hc, Wc)
        else:
            raw = self._coarse(R1, self.W1)
            cands = self._sel(raw, self.feats1, Hc, Wc)
        return self._refine(R0, cands, self.feats0)

    def match_batch_list(
        self, rgbs: jnp.ndarray, depths_mm: jnp.ndarray | None = None
    ) -> list[M.Matches]:
        """match_batch, unstacked to per-frame Matches records."""
        m = self.match_batch(rgbs, depths_mm)
        return [M.Matches(*(a[b] for a in m)) for b in range(rgbs.shape[0])]


class MultiClassBatchedMatcher:
    """One merged pipeline for SEVERAL object classes per frame batch.

    cv::linemod's Detector::match scores all class_ids in one call
    (rgbdDetector.cpp:31-34 passes the full detector); the reference's
    two-object Ensenso service (SURVEY.md C18) alternates two single-class
    detectors and pays preprocess, the prune bound, and patch assembly
    once PER CLASS even though none of them depend on the bank.  Here the
    classes' template axes are concatenated (ops.match.concat_level_features)
    so one preprocess -> one prune -> one survivor GEMM -> one
    refinement-walk dispatch serves every class; only the (cheap) candidate
    selection runs per class, with per-class thresholds.

    Exactness matches the per-class BatchedMatcher(prune=True) bit for bit
    (tests/test_multiclass.py): the prune bound runs at min(thresholds), so
    its survivor set is a superset for every class, and the in-graph
    exhaustive fallback fires on overflow exactly as in the single-class
    path.
    """

    def __init__(self, detector, class_ids: list[str], thresholds,
                 batch: int, top_k: int = 256, prune_pos_cap: int = 256,
                 fine_g: int | None = 4, fine_pos_cap: int | None = None,
                 prune_mode: str = "positions",
                 pool_coarse: int | None = None, pool_fine: int | None = None,
                 sel_row_cap: int = 128):
        if isinstance(thresholds, (int, float)):
            thresholds = [float(thresholds)] * len(class_ids)
        assert len(thresholds) == len(class_ids)
        p = detector.params
        self.class_ids = list(class_ids)
        self.thresholds = [float(t) for t in thresholds]
        self.T0, self.T1 = p.t_pyramid
        self.top_k = top_k
        self.batch = batch
        self.use_depth = p.use_depth_normal
        self.weak = p.color.weak_threshold
        self.prune_pos_cap = prune_pos_cap
        self.prune_mode = prune_mode
        self.pool_coarse = pool_coarse if pool_coarse is not None else 64 * batch
        self.pool_fine = pool_fine if pool_fine is not None else 32 * batch
        self.sel_row_cap = sel_row_cap
        self.last_pool = None
        self.last_prune = None

        banks = [detector.bank(c) for c in class_ids]
        self.Kc1 = max(b.max_cell_extent(1) for b in banks)
        self.E0 = max(b.extent(0) for b in banks)
        f1, bases = M.concat_level_features([b.merged_features(1) for b in banks])
        f0, bases0 = M.concat_level_features([b.merged_features(0) for b in banks])
        assert bases == bases0
        self.feats1, self.feats0 = f1, f0
        n_total = int(f1.count.shape[0])
        self.slices = tuple(
            (bases[i], bases[i + 1] if i + 1 < len(bases) else n_total)
            for i in range(len(bases))
        )
        self.fine_g = fine_g if self.T1 % (fine_g or 1) == 0 else None
        self.fine_pos_cap = M._default_cap(fine_pos_cap, prune_pos_cap,
                                           "fine_pos_cap")
        C = 16 if self.use_depth else 8
        self.W1 = M.build_gemm_weights(f1, C, self.T1, self.Kc1)
        self.W_cell = M.build_cell_weights(f1, C, self.T1, self.Kc1)
        self.W_fine = (M.build_cell_weights_fine(f1, C, self.T1, self.Kc1,
                                                 self.fine_g)
                       if self.fine_g else None)
        self._build()

    def _build(self):
        T0, T1, Kc1, E0 = self.T0, self.T1, self.Kc1, self.E0
        use_depth = self.use_depth
        sel_thrs = tuple(t - 5.0 for t in self.thresholds)
        thr_min = min(self.thresholds)
        top_k, m_cap = self.top_k, self.prune_pos_cap

        self._pre = jax.jit(lambda rgbs, depths: M.preprocess_frames_batched(
            rgbs, depths, T0=T0, T1=T1, use_depth=use_depth,
            weak_threshold=self.weak))

        g, m2_cap = self.fine_g, self.fine_pos_cap

        if self.prune_mode == "pooled":
            if not g:
                raise ValueError("prune_mode='pooled' requires a fine_g "
                                 f"that divides T1={T1}")
            p1, p2, rcap = self.pool_coarse, self.pool_fine, self.sel_row_cap

            def _match_mc(Rb, W_gemm, W_cell, W_fine, f1, Hc, Wc):
                vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
                return M.match_pooled_multiclass(
                    Rb, W_gemm, W_cell, W_fine, f1.count, vpos, self.slices,
                    sel_thrs, T1, Kc1, g, p1, p2, top_k, Wc, r_cap=rcap,
                )
        else:
            def _match_mc(Rb, W_gemm, W_cell, W_fine, f1, Hc, Wc):
                vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
                cands, pr = M.match_coarse_pruned_multiclass(
                    Rb, W_gemm, W_cell, W_fine, f1.count, vpos, self.slices,
                    sel_thrs, T1, Kc1, m_cap, top_k, Wc, g=g, m2_cap=m2_cap,
                )
                return cands, None, pr

        self._match_mc = jax.jit(_match_mc, static_argnames=("Hc", "Wc"))
        # One refinement dispatch over the MERGED candidates of all classes
        # (re-sorted per frame so the valid candidates form the sorted
        # prefix the walk skip needs), gated at the loosest threshold;
        # per-class thresholds re-gate the output below.
        self._refine = jax.jit(
            lambda R0, cand, f0, nv: M.refine_candidates_opencv_batched(
                R0, f0, cand, T1, thr_min, E0=E0, fine_T=T0, n_valid=nv,
            )
        )
        # The merge and the per-class split+gate are jitted too: eager
        # NamedTuple shuffling costs ~6 dispatches each on the serving
        # hot path.
        self._merge = jax.jit(M.merge_candidates_sorted)
        self._split = jax.jit(lambda m: tuple(
            mi._replace(valid=mi.valid & (mi.similarity >= thr))
            for mi, thr in zip(
                M.split_matches_by_class(m, self.slices, self.top_k),
                self.thresholds,
            )
        ))

    def match_batch(self, rgbs, depths_mm=None) -> dict[str, M.Matches]:
        """(B, H, W, 3) uint8 [+ (B, H, W) mm] -> {class_id: Matches} with
        (B, top_k) arrays, template ids re-based per class."""
        if self.use_depth and depths_mm is None:
            raise ValueError(
                "this bank uses the DepthNormal modality: match_batch "
                "requires depths_mm (B, H, W) in millimetres"
            )
        if self.use_depth:
            R0, R1 = self._pre(rgbs, depths_mm)
        else:
            R0, R1 = self._pre(rgbs, jnp.zeros(rgbs.shape[:3], jnp.float32))
        Hc, Wc = R1.shape[2] // self.T1, R1.shape[3] // self.T1
        cands, nvs, pr = self._match_mc(R1, self.W1, self.W_cell,
                                        self.W_fine, self.feats1, Hc, Wc)
        if self.prune_mode == "pooled":
            self.last_pool = pr
        else:
            self.last_prune = pr
        # Merge the classes' candidates and re-sort per frame: ONE walk
        # dispatch over the valid prefix of ALL classes (the global
        # top-candidate selection across classes — the walk's cost follows
        # the total VALID count, not classes x top_k slots).
        cat, nv = self._merge(cands)
        m = self._refine(R0, cat, self.feats0, nv)
        split = self._split(m)
        return dict(zip(self.class_ids, split))


class PipelinedRunner:
    """Keep up to `depth` dispatched steps in flight on the device.

    JAX dispatch is asynchronous: submit() enqueues a step's outputs
    WITHOUT blocking, collect() blocks on the OLDEST in-flight step only.
    With depth=2 the host round-trip of a blocking collect hides behind
    the next frame's device compute, taking the blocking per-frame period
    from device+RTT down to max(device, RTT).  The reference's serving loop
    is fully synchronous per frame (grab -> detect -> respond,
    linemod_ensenso_detect_3_mult_detect_service.cpp:274-599), so its
    latency is the capability floor, not the design bar.

    Results come out in submission order; submitting past `depth` blocks
    on (and returns) the oldest result to bound in-flight device memory.
    """

    def __init__(self, fn, depth: int = 2):
        from collections import deque

        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        self.fn = fn
        self.depth = depth
        self._q = deque()

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, *args, **kwargs):
        """Dispatch one step; returns the oldest COMPLETED result when the
        pipeline was full, else None.

        Dispatch happens BEFORE the blocking collect: if fn raises (e.g. a
        transient RESOURCE_EXHAUSTED), no already-collected result is lost
        and the in-flight queue is unchanged, so caller-side metadata
        pairing (one stamp per submitted frame) stays in sync.  The queue
        momentarily holds depth+1 dispatched steps inside this call."""
        self._q.append(self.fn(*args, **kwargs))
        if len(self._q) > self.depth:
            return self.collect()
        return None

    def collect(self):
        """Block on and return the oldest in-flight result."""
        if not self._q:
            raise RuntimeError("collect() with nothing in flight")
        out = self._q.popleft()
        jax.block_until_ready(out)
        return out

    def drain(self) -> list:
        """Collect every remaining in-flight result, oldest first."""
        out = []
        while self._q:
            out.append(self.collect())
        return out


def look_at_point(cloud: jnp.ndarray, rect_xywh, cap: int = 256) -> jnp.ndarray:
    """3-D gaze target at a detection's bbox center (carmine
    get_look_at_point semantics: NaN center -> walk to a valid neighbour;
    here: nearest finite point in the bbox)."""
    H, W = cloud.shape[:2]
    x, y, w, h = (jnp.asarray(v) for v in rect_xywh)
    cy = jnp.clip(y + h // 2, 0, H - 1)
    cx = jnp.clip(x + w // 2, 0, W - 1)
    center = cloud[cy, cx]
    pts, valid = pcu.extract_rect_points(cloud, jnp.stack([x, y, w, h]), cap)
    fallback = pcu.nearest_point(pts, valid, pcu.masked_centroid(pts, valid))
    return jnp.where(jnp.all(jnp.isfinite(center)), center, fallback)


def template_refinement(
    pose: jnp.ndarray,
    cloud: jnp.ndarray,
    rect_xywh,
    triangles: jnp.ndarray,
    K_render: jnp.ndarray,
    render_wh: tuple[int, int],
    model_cap: int = 1024,
    scene_cap: int = 1024,
    bias_x: int = 0,
    viewport: int = 256,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One re-render + re-ICP round at an estimated pose (carmine
    templateRefinement): returns (refined pose, icp fitness).

    `viewport`: centered re-render window (the object projects at the
    principal point; see CascadeParams.render_viewport).  0 = full frame."""
    from .renderer import render as render_fn
    from .cascade import _transplanted_scene_mask, _compact_points, dilate_mask

    rw, rh = render_wh
    if viewport and viewport < min(rw, rh):
        K_render = K_render.at[0, 2].set(viewport / 2.0).at[1, 2].set(viewport / 2.0)
        rw = rh = viewport
    R = pose[:3, :3]
    t = pose[:3, 3]
    T_bank = R.T @ t  # render() camera parameterization: X_cam = R(X + T)
    out = render_fn(triangles, R.astype(jnp.float32), T_bank.astype(jnp.float32),
                    K_render, rw, rh)
    mcloud = pcu.depth_to_cloud(out.depth_mm / 1000.0, K_render)
    msel = (out.mask > 0) & jnp.all(jnp.isfinite(mcloud), axis=-1)
    model_pts, model_valid = _compact_points(mcloud.reshape(-1, 3), msel.reshape(-1), model_cap)
    # Recenter the rendered model at the pose translation (the render puts
    # the object along the optical axis at |T|).
    mc = pcu.masked_centroid(model_pts, model_valid)
    model_pts = model_pts - mc[None, :] + t[None, :]

    H, W = cloud.shape[:2]
    x, y, w, h = rect_xywh
    smask = _transplanted_scene_mask(
        out.mask, out.rect, jnp.asarray(x + bias_x), jnp.asarray(y), H, W
    )
    # keep the full outline despite the match-px plateau (no-wrap dilation)
    smask = dilate_mask(smask, 2)
    ssel = smask & jnp.all(jnp.isfinite(cloud), axis=-1)
    scene_pts, scene_valid = _compact_points(cloud.reshape(-1, 3), ssel.reshape(-1), scene_cap)

    res = icp_two_stage(model_pts, model_valid, scene_pts, scene_valid)
    return res.transform @ pose, res.fitness
