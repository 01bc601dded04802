"""The Detector: cv::linemod::Detector-compatible host API over the device
scoring engine.

Mirrors the public surface the reference uses (SURVEY.md section 2.2 E1):
`add_template(sources, class_id, mask)`, `match(sources, threshold)`,
`read/write` (YAML banks), `class_ids`, `num_templates`, plus direct bank
attachment for params-yml metadata.  One Detector holds one or more classes;
each class's bank is scored in a single batched device pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops import backend
from ..ops import match as M
from .templates import (
    DetectorParams,
    RendererGlobals,
    TemplateBank,
    TemplateFeatures,
    TemplateMetadata,
    extract_template,
)


@dataclass
class MatchResult:
    """Host-side view of matches for one class (cv::linemod::Match analog)."""

    class_id: str
    x: np.ndarray  # (M,) int
    y: np.ndarray
    template_id: np.ndarray
    similarity: np.ndarray  # percent

    def __len__(self) -> int:
        return len(self.x)


class Detector:
    def __init__(
        self, params: DetectorParams | None = None, f_cap: int = 64, engine: str = "auto"
    ):
        """engine: "conv" (one-hot GEMM scoring), "gather" (linearized-plane
        gather scan — the bit-identical reference implementation both are
        tested against), or "auto" (ops.backend.detector_engine decides).
        """
        self.params = params or DetectorParams()
        self.f_cap = f_cap
        if engine == "auto":
            engine = backend.detector_engine()
        self.engine = engine
        self._templates: dict[str, list[TemplateFeatures]] = {}
        self._banks: dict[str, TemplateBank] = {}

    # -- template management ------------------------------------------------

    @property
    def class_ids(self) -> list[str]:
        return list(self._templates.keys())

    def num_templates(self, class_id: str | None = None) -> int:
        if class_id is not None:
            return len(self._templates.get(class_id, []))
        return sum(len(v) for v in self._templates.values())

    def add_template(
        self,
        rgb: np.ndarray,
        mask: np.ndarray,
        class_id: str = "obj",
        depth_mm: np.ndarray | None = None,
        precomputed: dict | None = None,
    ) -> int:
        """Extract and store a template; returns its id or -1 on failure
        (the reference skips such views, renderer.cpp:308-315)."""
        t = extract_template(rgb, depth_mm, mask, self.params, precomputed)
        if t is None:
            return -1
        self._templates.setdefault(class_id, []).append(t)
        self._banks.pop(class_id, None)  # invalidate cached arrays
        return len(self._templates[class_id]) - 1

    def attach_bank(self, bank: TemplateBank) -> None:
        self._templates[bank.class_id] = bank.templates
        self._banks[bank.class_id] = bank

    def bank(self, class_id: str) -> TemplateBank:
        if class_id not in self._banks:
            self._banks[class_id] = TemplateBank(
                class_id, self.params, self._templates[class_id], f_cap=self.f_cap
            )
        return self._banks[class_id]

    def template_rect0(self, class_id: str, template_id: int) -> tuple[int, int, int, int]:
        return self._templates[class_id][template_id].rect0

    # -- matching -----------------------------------------------------------

    def match_raw(
        self,
        rgb: np.ndarray,
        threshold: float,
        depth_mm: np.ndarray | None = None,
        class_ids: list[str] | None = None,
        top_k: int = 512,
    ) -> dict[str, M.Matches]:
        """Device-side match: padded Matches arrays with validity masks
        (feed these straight into the cascade without host sync)."""
        p = self.params
        use_depth = p.use_depth_normal and depth_mm is not None
        pyr = M.preprocess_frame(
            jnp.asarray(rgb),
            jnp.asarray(depth_mm) if depth_mm is not None else None,
            T0=p.t_pyramid[0],
            T1=p.t_pyramid[1],
            use_depth=use_depth,
            weak_threshold=p.color.weak_threshold,
        )
        out: dict[str, M.Matches] = {}
        for cid in class_ids or self.class_ids:
            bank = self.bank(cid)
            out[cid] = self._match_class(bank, pyr, threshold, top_k)
        return out

    def match(
        self,
        rgb: np.ndarray,
        threshold: float,
        depth_mm: np.ndarray | None = None,
        class_ids: list[str] | None = None,
        top_k: int = 512,
    ) -> dict[str, MatchResult]:
        """Full pyramid match of every class over one frame.

        Stage order per cv::linemod::Detector::match (SURVEY.md section 3.2
        step 4): quantize -> spread -> response maps at both levels, coarse
        T-strided scoring at the pyramid top, threshold + top-k, then
        level-0 local refinement reporting the finest-level similarity.
        """
        raw = self.match_raw(rgb, threshold, depth_mm, class_ids, top_k)
        out: dict[str, MatchResult] = {}
        for cid, matches in raw.items():
            ok = np.asarray(matches.valid)
            out[cid] = MatchResult(
                class_id=cid,
                x=np.asarray(matches.x)[ok],
                y=np.asarray(matches.y)[ok],
                template_id=np.asarray(matches.template_id)[ok],
                similarity=np.asarray(matches.similarity)[ok],
            )
        return out

    def _response_stacks(self, bank: TemplateBank, pyr: M.FramePyramid):
        p = self.params
        r1 = [pyr.grad_r1] if p.use_color_gradient else []
        r0 = [pyr.grad_r0] if p.use_color_gradient else []
        if p.use_depth_normal:
            r1.append(pyr.norm_r1)
            r0.append(pyr.norm_r0)
        R1 = r1[0] if len(r1) == 1 else jnp.concatenate(r1, axis=0)
        R0 = r0[0] if len(r0) == 1 else jnp.concatenate(r0, axis=0)
        return R0, R1

    def _match_class(
        self, bank: TemplateBank, pyr: M.FramePyramid, threshold: float, top_k: int
    ) -> M.Matches:
        p = self.params
        T0, T1 = p.t_pyramid[0], p.t_pyramid[1]
        R0, R1 = self._response_stacks(bank, pyr)
        feats1 = bank.merged_features(1)
        feats0 = bank.merged_features(0)

        if self.engine == "conv":
            raw = M.coarse_scores_gemm(
                R1, bank.gemm_weights(1), T1, bank.max_cell_extent(1)
            )
        else:
            raw = M.coarse_scores(R1, feats1, T1, bank.max_cell_extent(1))
        Hc, Wc = raw.shape[1:]
        vpos = M.position_validity(feats1.size, T1, Hc, Wc)
        # Coarse pass gate: slightly relaxed threshold (the reported score is
        # the level-0 one; OpenCV also thresholds the coarse level directly).
        cand = M.select_candidates(raw, feats1.count, vpos, threshold - 5.0, top_k)
        # cv::linemod's exact local-refinement walk: positions and scores are
        # bit-identical to the genuine engine (tests/test_oracle_parity.py).
        return M.refine_candidates_opencv(
            R0, feats0, cand, T1, threshold, E0=bank.extent(0), fine_T=T0
        )

    # -- fused single-dispatch matcher (bench / serving path) ---------------

    def make_matcher_fn(
        self, class_id: str, threshold: float, top_k: int = 512,
    ):
        """Build the serving hot path: fn(rgb[, depth_mm]) -> Matches.

        Dispatches as a chain of stage-level jitted programs with the bank
        arrays passed as ARGUMENTS — closing over them would embed hundreds
        of MB of constants in one HLO, which makes compiles pathological.
        Stage chaining is async.
        """
        import jax

        p = self.params
        bank = self.bank(class_id)
        T0, T1 = p.t_pyramid[0], p.t_pyramid[1]
        use_depth = p.use_depth_normal
        W1 = bank.gemm_weights(1)
        Kc1 = bank.max_cell_extent(1)
        E0 = bank.extent(0)
        feats1 = bank.merged_features(1)
        feats0 = bank.merged_features(0)
        # cv::linemod's exact walk (form chosen by ops.backend) —
        # positions/scores bit-identical to the genuine engine.
        def refine(R0, f0, cand, T1, thr, E0, fine_T):
            m = M.refine_candidates_opencv_batched(
                R0[None], f0, M.CoarseMatches(*(a[None] for a in cand)),
                T1, thr, E0, fine_T,
            )
            return M.Matches(*(a[0] for a in m))

        # Position-major (Hc*Wc, N) scores, the GEMM's natural layout.
        coarse = jax.jit(lambda R, W: M.coarse_scores_gemm_flat(R, W, T1, Kc1))

        def _sel_flat(raw_flat, f1, Hc, Wc):
            vpos = M.position_validity_flat(f1.size, T1, Hc, Wc)
            return M.select_candidates_flat(
                raw_flat, f1.count, vpos, threshold - 5.0, top_k, Wc,
            )

        sel = jax.jit(_sel_flat, static_argnames=("Hc", "Wc"))
        ref = jax.jit(
            lambda R0, f0, cand: refine(R0, f0, cand, T1, threshold, E0=E0, fine_T=T0)
        )

        def fn(rgb, depth_mm=None):
            pyr = M.preprocess_frame(
                rgb, depth_mm, T0=T0, T1=T1, use_depth=use_depth,
                weak_threshold=p.color.weak_threshold,
            )
            R0, R1 = self._response_stacks(bank, pyr)
            raw = coarse(R1, W1)
            Hc, Wc = R1.shape[1] // T1, R1.shape[2] // T1
            cand = sel(raw, feats1, Hc, Wc)
            return ref(R0, feats0, cand)

        return fn

    # -- serialization ------------------------------------------------------

    def write(self, path: str, class_id: str | None = None) -> None:
        cid = class_id or self.class_ids[0]
        self.bank(cid).write_templates_yaml(path)

    @classmethod
    def read(cls, path: str, f_cap: int = 64) -> "Detector":
        bank = TemplateBank.read_templates_yaml(path, f_cap=f_cap)
        det = cls(bank.params, f_cap=f_cap)
        det.attach_bank(bank)
        return det
