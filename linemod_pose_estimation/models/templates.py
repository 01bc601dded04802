"""Template extraction + the padded template-bank arrays fed to the matcher.

Replaces cv::linemod's Modality::extractTemplate + Detector::addTemplate
storage and the reference's two-file bank serialization (SURVEY.md C14, C15):

- feature extraction (offline, host numpy + JAX quantizers): strongest
  scattered gradient features above strong_threshold (OpenCV
  ColorGradient::extractTemplate semantics: stable-sort by magnitude,
  greedy scatter selection with shrinking min distance), and interior
  surface-normal features ranked by distance-to-mask-border (OpenCV
  DepthNormal::extractTemplate with extract_threshold).
- two pyramid levels; features of both levels cropped to a common bbox
  (cv::linemod cropTemplates): match.x/y refers to the bbox origin.
- TemplateBank: stacked fixed-size arrays (LevelFeatures per level per
  modality) + per-template pose metadata {R, T, K, D, Ori_dist, Rect}
  matching the renderer_params.yml schema (renderer.cpp:72-123), plus
  detector-config YAML mirroring cv::linemod::Detector::write/writeClass.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import features as FO
from ..ops.match import LevelFeatures
from ..utils import opencv_yaml as oy


def _maybe_ungz(path: str) -> str:
    """Decompress a `.gz` bank to a cached temp file so the native C++
    parser (and the PyYAML fallback) always see plain YAML.  Committed
    banks ship gzipped; cv::FileStorage reads `.gz` transparently and so
    do we (rgbdDetector.cpp:1694 reads the shipped plain files)."""
    if not path.endswith(".gz"):
        return path
    import gzip
    import hashlib
    import os
    import tempfile

    st = os.stat(path)
    tag = hashlib.sha1(
        f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}".encode()
    ).hexdigest()[:16]
    dst = os.path.join(tempfile.gettempdir(), f"lpe_bank_{tag}.yml")
    if not os.path.exists(dst):
        # Unique temp per process: concurrent loaders (pytest-xdist, two
        # serving processes) would otherwise interleave writes into one
        # shared .part file and publish a corrupt bank; with per-process
        # temps the atomic os.replace makes the race last-writer-wins
        # with identical content.
        tmp = f"{dst}.{os.getpid()}.part"
        try:
            with gzip.open(path, "rb") as f, open(tmp, "wb") as g:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    g.write(chunk)
            os.replace(tmp, dst)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return dst


@dataclass
class ModalityParams:
    weak_threshold: float = 10.0
    num_features: int = 63
    strong_threshold: float = 55.0
    # DepthNormal:
    distance_threshold: float = 2000.0
    difference_threshold: float = 50.0
    extract_threshold: int = 2


@dataclass
class DetectorParams:
    t_pyramid: tuple[int, ...] = (5, 8)  # T at level 0, level 1 (ref renderer.cpp:182-185)
    use_color_gradient: bool = True
    use_depth_normal: bool = False
    color: ModalityParams = field(default_factory=ModalityParams)
    depth: ModalityParams = field(default_factory=ModalityParams)

    @property
    def pyramid_levels(self) -> int:
        return len(self.t_pyramid)


@dataclass
class TemplateFeatures:
    """One template: per-level, per-modality feature lists (numpy)."""

    # lists over pyramid levels; each entry (F, 3) int32 rows (y, x, ori)
    grad: list[np.ndarray]
    norm: list[np.ndarray]
    size: list[tuple[int, int]]  # (h, w) per level of the cropped bbox
    rect0: tuple[int, int, int, int]  # level-0 (x, y, w, h) bbox in the source image


def _select_scattered(candidates: np.ndarray, scores: np.ndarray, num: int) -> np.ndarray:
    """OpenCV selectScatteredFeatures: walk candidates in score order, keep
    those >= `distance` from every ALREADY-KEPT feature; when the scan wraps,
    relax distance by 1 and continue — accepted features persist across
    relaxations (they are never cleared), matching OpenCV's loop structure.
    """
    order = np.argsort(-scores, kind="stable")
    return _select_from_sorted(candidates[order], num)


def _select_from_sorted(cand: np.ndarray, num: int) -> np.ndarray:
    """selectScatteredFeatures walk over candidates ALREADY in score order
    (the trainer sorts on device; numpy stable argsort and jnp stable
    argsort order ties identically — by original index)."""
    n = cand.shape[0]
    if n == 0:
        return cand
    distance = float(n / num + 1)
    cap = min(num, n)
    cy = cand[:, 0].astype(np.float64)
    cx = cand[:, 1].astype(np.float64)
    # mind2[i] = squared distance from candidate i to its nearest KEPT
    # feature; updated incrementally on every accept.  Each relaxation wrap
    # then reduces to one vectorized mind2 >= d^2 test plus a short
    # sequential re-check, and wraps that cannot admit anything are skipped
    # by jumping distance straight to floor-equivalent of the best mind2 —
    # exact-equivalent to the naive walk (pinned by a test) but ~1000x
    # faster on dense candidate sets (depth-normal candidates are the whole
    # mask interior, so distance starts ~n/num ~ hundreds of px).
    mind2 = np.full(n, np.inf)
    kept_idx: list[int] = []
    while len(kept_idx) < cap and distance >= 1.0:
        d2 = distance * distance
        passing = np.nonzero(mind2 >= d2)[0]
        for j in passing:
            if mind2[j] >= d2:  # re-check vs accepts earlier in this wrap
                kept_idx.append(j)
                np.minimum(
                    mind2, (cy - cy[j]) ** 2 + (cx - cx[j]) ** 2, out=mind2
                )
                if len(kept_idx) == cap:
                    break
        if len(kept_idx) == cap:
            break
        # After a full wrap every candidate has mind2 < d2; the next wrap
        # that can admit anything is at distance' = distance - k with
        # k = ceil(distance - sqrt(max mind2)).  Jumping there visits the
        # same candidates in the same order as walking each empty wrap.
        s = float(np.sqrt(mind2.max()))
        distance -= max(1.0, float(np.ceil(distance - s)))
    return cand[kept_idx].copy() if kept_idx else cand[:0].copy()


def _bit_to_index(bitmask: np.ndarray) -> np.ndarray:
    """uint8 one-hot bitmask -> bin index (valid only where nonzero)."""
    return np.argmax((bitmask[..., None] >> np.arange(8)) & 1, axis=-1).astype(np.int32)


def extract_gradient_features(
    rgb: np.ndarray, mask: np.ndarray, params: ModalityParams, num: int,
    precomputed: tuple[np.ndarray, np.ndarray] | None = None,
) -> np.ndarray | None:
    """(y, x, ori) rows for one pyramid level, or None if too few features.

    `precomputed` supplies (quant, mag2) from a batched device pass (the
    trainer quantizes a whole render chunk in one dispatch — per-view
    device round-trips dominate training time otherwise)."""
    if precomputed is not None:
        quant, mag2 = precomputed
    else:
        quant, mag2 = FO.quantize_color_gradient(
            jnp.asarray(rgb), params.weak_threshold
        )
    quant = np.asarray(quant)
    mag2 = np.asarray(mag2)
    strong2 = params.strong_threshold**2
    sel = (quant != 0) & (mag2 > strong2) & (mask > 0)
    ys, xs = np.nonzero(sel)
    if ys.size < num // 2 or ys.size == 0:
        return None
    oris = _bit_to_index(quant[ys, xs])
    cand = np.stack([ys, xs, oris], axis=1).astype(np.int32)
    feats = _select_scattered(cand, mag2[ys, xs], num)
    return feats if feats.shape[0] >= num // 2 else None


def extract_normal_features(
    depth_mm: np.ndarray, mask: np.ndarray, params: ModalityParams, num: int,
    precomputed: np.ndarray | None = None,
) -> np.ndarray | None:
    if precomputed is not None:
        quant = np.asarray(precomputed)
    else:
        quant = np.asarray(
            FO.quantize_depth_normal(
                jnp.asarray(depth_mm.astype(np.float32)),
                params.distance_threshold,
                params.difference_threshold,
            )
        )
    try:
        from scipy.ndimage import distance_transform_edt

        dist = distance_transform_edt(mask > 0)
    except Exception:  # pragma: no cover
        dist = (mask > 0).astype(np.float32)
    sel = (quant != 0) & (dist > params.extract_threshold)
    ys, xs = np.nonzero(sel)
    if ys.size == 0:
        return None
    oris = _bit_to_index(quant[ys, xs])
    cand = np.stack([ys, xs, oris], axis=1).astype(np.int32)
    feats = _select_scattered(cand, dist[ys, xs], num)
    return feats if feats.shape[0] >= num // 2 else None


def _pyr_down_np(img: np.ndarray) -> np.ndarray:
    return np.asarray(FO.pyr_down(jnp.asarray(img.astype(np.float32))))


def extract_template(
    rgb: np.ndarray,
    depth_mm: np.ndarray | None,
    mask: np.ndarray,
    params: DetectorParams,
    precomputed: dict | None = None,
) -> TemplateFeatures | None:
    """Extract a multi-level template; None mimics addTemplate == -1
    (too few features -> view skipped, ref renderer.cpp:308-315).

    `precomputed`, when given, holds per-level quantizations from a batched
    device pass: {"grad": [(quant, mag2), ...], "norm": [quant, ...]}.
    """
    levels = params.pyramid_levels
    grad_l: list[np.ndarray] = []
    norm_l: list[np.ndarray] = []
    cur_rgb = rgb.astype(np.float32)
    # Depth quantizes ONCE at level 0; coarser levels subsample the
    # quantized normals (DepthNormalPyramid::pyrDown, probed bit-exact
    # against the genuine engine — NOT a re-quantize of decimated depth).
    cur_qnorm = None
    if params.use_depth_normal and depth_mm is not None and precomputed is None:
        cur_qnorm = np.asarray(
            FO.quantize_depth_normal(
                jnp.asarray(depth_mm.astype(np.float32)),
                params.depth.distance_threshold,
                params.depth.difference_threshold,
            )
        )
    cur_mask = (mask > 0).astype(np.uint8)
    for l in range(levels):
        if params.use_color_gradient:
            g = extract_gradient_features(
                cur_rgb, cur_mask, params.color, params.color.num_features,
                precomputed=precomputed["grad"][l] if precomputed else None,
            )
            if g is None:
                return None
            grad_l.append(g)
        if params.use_depth_normal:
            if depth_mm is None:
                return None
            n = extract_normal_features(
                None, cur_mask, params.depth, params.depth.num_features,
                precomputed=precomputed["norm"][l] if precomputed
                else cur_qnorm,
            )
            if n is None:
                return None
            norm_l.append(n)
        if l + 1 < levels:
            if precomputed is None:
                cur_rgb = np.stack(
                    [_pyr_down_np(cur_rgb[..., c]) for c in range(cur_rgb.shape[-1])], axis=-1
                )
            if cur_qnorm is not None:
                cur_qnorm = cur_qnorm[::2, ::2]
            cur_mask = cur_mask[::2, ::2]

    # Crop to common bbox in level-0 coords (cv::linemod cropTemplates).
    all_xy0: list[np.ndarray] = []
    for l in range(levels):
        for fl in ([grad_l[l]] if params.use_color_gradient else []) + (
            [norm_l[l]] if params.use_depth_normal else []
        ):
            all_xy0.append(fl[:, :2].astype(np.int64) << l)
    cat = np.concatenate(all_xy0, axis=0)
    y0, x0 = cat[:, 0].min(), cat[:, 1].min()
    y1, x1 = cat[:, 0].max(), cat[:, 1].max()
    sizes = []
    for l in range(levels):
        oy_, ox_ = int(y0) >> l, int(x0) >> l
        if params.use_color_gradient:
            grad_l[l] = grad_l[l] - np.array([oy_, ox_, 0], np.int32)
        if params.use_depth_normal:
            norm_l[l] = norm_l[l] - np.array([oy_, ox_, 0], np.int32)
        sizes.append((int(y1 - y0) >> l, int(x1 - x0) >> l))
    return TemplateFeatures(
        grad=grad_l if params.use_color_gradient else [],
        norm=norm_l if params.use_depth_normal else [],
        size=sizes,
        rect0=(int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)),
    )


# ---------------------------------------------------------------------------
# Bank arrays
# ---------------------------------------------------------------------------


@dataclass
class TemplateMetadata:
    """Per-template pose metadata — renderer_params.yml schema
    (writeLinemodTemplateParams, renderer.cpp:72-123)."""

    R: np.ndarray  # (N, 3, 3) float64
    T: np.ndarray  # (N, 3) float64
    K: np.ndarray  # (N, 3, 3) float32
    D: np.ndarray  # (N,) float64   (Ori_dist - center surface depth)
    Ori_dist: np.ndarray  # (N,) float64
    Rect: np.ndarray  # (N, 4) int32 — renderer mask bbox at level 0


@dataclass
class RendererGlobals:
    n_points: int = 150
    angle_step: int = 10
    radius_min: float = 0.5
    radius_max: float = 1.0
    radius_step: float = 0.1
    width: int = 640
    height: int = 480
    focal_length_x: float = 535.566011
    focal_length_y: float = 537.168115
    near: float = 0.1
    far: float = 1000.0


def stack_level_features(
    templates: list[TemplateFeatures], level: int, modality: str, f_cap: int
) -> LevelFeatures:
    """Pad one (level, modality)'s features across the bank into arrays."""
    N = len(templates)
    offsets = np.zeros((N, f_cap, 2), np.int32)
    oris = np.zeros((N, f_cap), np.int32)
    count = np.zeros((N,), np.int32)
    size = np.zeros((N, 2), np.int32)
    for i, t in enumerate(templates):
        fl = (t.grad if modality == "grad" else t.norm)[level]
        n = min(fl.shape[0], f_cap)
        offsets[i, :n] = fl[:n, :2]
        oris[i, :n] = fl[:n, 2]
        count[i] = n
        size[i] = t.size[level]
    live = np.arange(f_cap, dtype=np.int32)[None, :] < count[:, None]
    return LevelFeatures(
        offsets=jnp.asarray(offsets),
        oris=jnp.asarray(oris),
        live=jnp.asarray(live),
        count=jnp.asarray(count),
        size=jnp.asarray(size),
    )


class TemplateBank:
    """A class's templates as device-ready arrays + host metadata."""

    def __init__(
        self,
        class_id: str,
        params: DetectorParams,
        templates: list[TemplateFeatures],
        metadata: TemplateMetadata | None = None,
        globals_: RendererGlobals | None = None,
        f_cap: int = 64,
    ):
        self.class_id = class_id
        self.params = params
        self.templates = templates
        self.metadata = metadata
        self.globals = globals_ or RendererGlobals()
        self.f_cap = f_cap
        self._build_arrays()

    def _build_arrays(self) -> None:
        p = self.params
        self.levels: list[dict[str, LevelFeatures]] = []
        for l in range(p.pyramid_levels):
            d: dict[str, LevelFeatures] = {}
            if p.use_color_gradient:
                d["grad"] = stack_level_features(self.templates, l, "grad", self.f_cap)
            if p.use_depth_normal:
                d["norm"] = stack_level_features(self.templates, l, "norm", self.f_cap)
            self.levels.append(d)
        # Total features per template per level (for similarity normalization).
        self.total_features = []
        for l in range(p.pyramid_levels):
            tot = jnp.zeros((len(self.templates),), jnp.int32)
            for lf in self.levels[l].values():
                tot = tot + lf.count
            self.total_features.append(tot)

    @property
    def num_templates(self) -> int:
        return len(self.templates)

    def max_cell_extent(self, level: int) -> int:
        """Max template extent in T-cells at `level` (static for jit).

        Exactly max_offset // T + 1 — the GEMM K-dim scales with Kc^2, so an
        unused extra shift costs ~27% of the coarse contraction at T=8/E=48.
        NOTE: `size` stores the template's MAXIMUM feature offset (y1-y0,
        inclusive — see extract_template), so sizes.max() IS max_offset and
        no -1 belongs here.
        """
        T = self.params.t_pyramid[level]
        sizes = np.asarray(
            jnp.stack([lf.size for lf in self.levels[level].values()]).max(axis=0)
        )
        if sizes.size == 0:
            return 1
        return int(sizes.max()) // T + 1

    def extent(self, level: int) -> int:
        """Max template pixel extent at `level`, rounded up to a multiple of
        8 (the dense conv filter size; static for jit)."""
        sizes = np.asarray(
            jnp.stack([lf.size for lf in self.levels[level].values()]).max(axis=0)
        )
        e = int(sizes.max()) + 1 if sizes.size else 8
        return max((e + 7) // 8 * 8, 8)

    def merged_features(self, level: int):
        """Modality-merged LevelFeatures for this level (cached; the
        response-map stack is concatenated per frame to match)."""
        from ..ops.match import merge_modalities

        if not hasattr(self, "_merged"):
            self._merged = {}
        if level not in self._merged:
            fl = list(self.levels[level].values())
            dummy = [jnp.zeros((8, 8, 8), jnp.uint8)] * len(fl)
            merged, _ = merge_modalities(fl, dummy)
            self._merged[level] = merged
        return self._merged[level]

    def dense_weights(self, level: int):
        """One-hot conv filter bank for the conv scoring path (cached)."""
        from ..ops.match import build_dense_weights

        if not hasattr(self, "_dense_w"):
            self._dense_w = {}
        if level not in self._dense_w:
            merged = self.merged_features(level)
            C = 8 * len(self.levels[level])
            self._dense_w[level] = build_dense_weights(merged, C, self.extent(level))
        return self._dense_w[level]

    def gemm_weights(self, level: int):
        """One-hot GEMM weight matrix for the GEMM scoring paths (cached)."""
        from ..ops.match import build_gemm_weights

        if not hasattr(self, "_gemm_w"):
            self._gemm_w = {}
        if level not in self._gemm_w:
            merged = self.merged_features(level)
            C = 8 * len(self.levels[level])
            T = self.params.t_pyramid[level]
            self._gemm_w[level] = build_gemm_weights(
                merged, C, T, self.max_cell_extent(level)
            )
        return self._gemm_w[level]

    @property
    def num_modalities(self) -> int:
        return len(self.levels[0])

    def tiled(self, reps: int, pad_to: int) -> "TemplateBank":
        """This bank grown to deployment scale: its device features
        repeated `reps` times along the template axis and padded with dead
        templates to `pad_to` rows (ops.match.tile_level_features), as the
        benchmarks and chip_smoke.py run it.  Host-side templates and
        metadata stay the original's; a tiled template id maps back to
        id % num_templates."""
        import copy

        from ..ops.match import tile_level_features

        out = copy.copy(self)
        out._merged = {
            l: tile_level_features(self.merged_features(l), reps, pad_to)
            for l in range(self.params.pyramid_levels)
        }
        out._gemm_w = {}
        out._dense_w = {}
        return out

    # -- serialization ------------------------------------------------------

    def write_params_yaml(self, path: str) -> None:
        """renderer_params.yml — byte-level schema of the reference
        (writeLinemodTemplateParams, renderer.cpp:72-123)."""
        if self.metadata is None:
            raise ValueError("bank has no pose metadata")
        m, g = self.metadata, self.globals
        doc: dict = {}
        for i in range(self.num_templates):
            doc[f"Template {i}"] = {
                "ID": i,
                "R": oy.CvMatrix(m.R[i].astype(np.float64)),
                "T": oy.CvMatrix(m.T[i].reshape(3, 1).astype(np.float64)),
                "K": oy.CvMatrix(m.K[i].astype(np.float32)),
                "D": float(m.D[i]),
                "Ori_dist": float(m.Ori_dist[i]),
                "Rect": [int(v) for v in m.Rect[i]],
            }
        doc["renderer_n_points"] = g.n_points
        doc["renderer_angle_step"] = g.angle_step
        doc["renderer_radius_min"] = g.radius_min
        doc["renderer_radius_max"] = g.radius_max
        doc["renderer_radius_step"] = g.radius_step
        doc["renderer_width"] = g.width
        doc["renderer_height"] = g.height
        doc["renderer_focal_length_x"] = g.focal_length_x
        doc["renderer_focal_length_y"] = g.focal_length_y
        doc["renderer_near"] = g.near
        doc["renderer_far"] = g.far
        oy.dump(doc, path)

    @staticmethod
    def write_render_dump(
        path: str,
        depths_mm: list[np.ndarray],
        masks: list[np.ndarray],
        rects: list[tuple[int, int, int, int]],
    ) -> None:
        """writeLinemodRender analog (renderer.cpp:125-146): per-template
        rendered depth (u16 mm), mask (u8) and Rect, as `Template i ->
        {ID, Depth, Mask, Rect}` FileStorage nodes.  Unused by the reference
        pipeline but part of its trainer surface."""
        doc: dict = {}
        for i, (d, m, rc) in enumerate(zip(depths_mm, masks, rects)):
            doc[f"Template {i}"] = {
                "ID": i,
                "Depth": oy.CvMatrix(np.asarray(d, np.uint16)),
                "Mask": oy.CvMatrix(np.asarray(m, np.uint8)),
                "Rect": [int(v) for v in rc],
            }
        oy.dump(doc, path)

    @staticmethod
    def read_render_dump(path: str):
        """Read a writeLinemodRender-format dump back: lists of (depth_mm,
        mask, rect)."""
        doc = oy.load(path)
        out = []
        i = 0
        while f"Template {i}" in doc:
            t = doc[f"Template {i}"]
            out.append((
                np.asarray(t["Depth"], np.uint16),
                np.asarray(t["Mask"], np.uint8),
                tuple(int(v) for v in t["Rect"]),
            ))
            i += 1
        return out

    @staticmethod
    def read_params_yaml(path: str) -> tuple[TemplateMetadata, RendererGlobals]:
        """Parse a renderer_params.yml (ours or the reference's shipped
        banks — readLinemodTemplateParams, rgbdDetector.cpp:1694-1749).

        Uses the native C++ parser (native/bank_loader.cpp, ~10x faster)
        when the toolchain built it; PyYAML otherwise — both bit-identical.
        `.gz` paths are decompressed to a temp file transparently.
        """
        from ..utils import native

        path = _maybe_ungz(path)
        nat = native.load_params_native(path) if native.available() else None
        if nat is not None:
            R, T, K, D, Od, Rect, g = nat
            meta = TemplateMetadata(R=R, T=T, K=K, D=D, Ori_dist=Od, Rect=Rect)
            globals_ = RendererGlobals(
                n_points=int(g[0]), angle_step=int(g[1]), radius_min=g[2],
                radius_max=g[3], radius_step=g[4], width=int(g[5]),
                height=int(g[6]), focal_length_x=g[7], focal_length_y=g[8],
                near=g[9], far=g[10],
            )
            return meta, globals_
        doc = oy.load(path)
        n = 0
        while f"Template {n}" in doc:
            n += 1
        R = np.zeros((n, 3, 3))
        T = np.zeros((n, 3))
        K = np.zeros((n, 3, 3), np.float32)
        D = np.zeros((n,))
        Od = np.zeros((n,))
        Rect = np.zeros((n, 4), np.int32)
        for i in range(n):
            t = doc[f"Template {i}"]
            R[i] = t["R"]
            T[i] = np.asarray(t["T"]).ravel()
            K[i] = t["K"]
            D[i] = t["D"]
            Od[i] = t["Ori_dist"]
            Rect[i] = t["Rect"]
        g = RendererGlobals(
            n_points=int(doc.get("renderer_n_points", 150)),
            angle_step=int(doc.get("renderer_angle_step", 10)),
            radius_min=float(doc.get("renderer_radius_min", 0.5)),
            radius_max=float(doc.get("renderer_radius_max", 1.0)),
            radius_step=float(doc.get("renderer_radius_step", 0.1)),
            width=int(doc.get("renderer_width", 640)),
            height=int(doc.get("renderer_height", 480)),
            focal_length_x=float(doc.get("renderer_focal_length_x", 535.566011)),
            focal_length_y=float(doc.get("renderer_focal_length_y", 537.168115)),
            near=float(doc.get("renderer_near", 0.1)),
            far=float(doc.get("renderer_far", 1000.0)),
        )
        return TemplateMetadata(R=R, T=T, K=K, D=D, Ori_dist=Od, Rect=Rect), g

    def _modality_names(self) -> list[str]:
        p = self.params
        return (["ColorGradient"] if p.use_color_gradient else []) + (
            ["DepthNormal"] if p.use_depth_normal else []
        )

    def write_templates_yaml(self, path: str) -> None:
        """Detector+templates YAML in cv::linemod's OWN serialization schema
        (Detector::write + writeClass + Template::write + Feature::write,
        as read back by the reference's readLinemod,
        rgbdDetector.cpp:1668-1692):

        - template entries carry NO modality name; a TemplatePyramid is the
          flat list tp[level*num_modalities + modality_index],
        - feature rows are ``[x, y, label]`` (Feature::write order; our
          internal rows are (y, x, ori) — swapped here at the boundary),
        - the class node lists its modality names,

        so banks written here load in OpenCV and vice versa.
        """
        p = self.params
        mods = []
        if p.use_color_gradient:
            mods.append(
                {
                    "type": "ColorGradient",
                    "weak_threshold": p.color.weak_threshold,
                    "num_features": p.color.num_features,
                    "strong_threshold": p.color.strong_threshold,
                }
            )
        if p.use_depth_normal:
            mods.append(
                {
                    "type": "DepthNormal",
                    "distance_threshold": p.depth.distance_threshold,
                    "difference_threshold": p.depth.difference_threshold,
                    "num_features": p.depth.num_features,
                    "extract_threshold": p.depth.extract_threshold,
                }
            )
        pyramids = []
        for i, t in enumerate(self.templates):
            tmpl_entries = []
            for l in range(p.pyramid_levels):
                mods_l = ([t.grad[l]] if p.use_color_gradient else []) + (
                    [t.norm[l]] if p.use_depth_normal else []
                )
                for fl in mods_l:
                    tmpl_entries.append(
                        {
                            "width": int(t.size[l][1]),
                            "height": int(t.size[l][0]),
                            "pyramid_level": l,
                            "features": oy.BlockRows(
                                [int(f[1]), int(f[0]), int(f[2])] for f in fl
                            ),
                        }
                    )
            pyramids.append({"template_id": i, "templates": tmpl_entries})
        doc = {
            "pyramid_levels": p.pyramid_levels,
            "modalities": mods,
            "T": list(p.t_pyramid),
            "classes": [
                {
                    "class_id": self.class_id,
                    "modalities": self._modality_names(),
                    "pyramid_levels": p.pyramid_levels,
                    "template_pyramids": pyramids,
                }
            ],
        }
        oy.dump(doc, path)

    @staticmethod
    def read_templates_yaml(path: str, f_cap: int = 64) -> "TemplateBank":
        from ..utils import native

        path = _maybe_ungz(path)
        nat = native.load_templates_native(path) if native.available() else None
        if nat is not None:
            entries, features, header, mparams = nat
            # header[1] is a modality bitmask: bit0 ColorGradient, bit1
            # DepthNormal (depth-only banks decode correctly).
            levels, mod_mask, T0, T1 = (int(v) for v in header)
            cp = ModalityParams(
                weak_threshold=float(mparams[0, 0]) or 10.0,
                num_features=int(mparams[0, 1]) or 63,
                strong_threshold=float(mparams[0, 2]) or 55.0,
            )
            dp = ModalityParams(
                distance_threshold=float(mparams[1, 0]) or 2000.0,
                difference_threshold=float(mparams[1, 1]) or 50.0,
                num_features=int(mparams[1, 2]) or 63,
                extract_threshold=int(mparams[1, 3]) or 2,
            )
            params = DetectorParams(
                t_pyramid=(T0, T1),
                use_color_gradient=bool(mod_mask & 1),
                use_depth_normal=bool(mod_mask & 2),
                color=cp,
                depth=dp,
            )
            templates: list[TemplateFeatures] = []
            fo = 0
            cur_pid = -1
            for e in entries:
                pid, w, h, level, mod, nf = (int(v) for v in e)
                if pid != cur_pid:
                    templates.append(
                        TemplateFeatures(
                            grad=[None] * levels, norm=[None] * levels,  # type: ignore
                            size=[(0, 0)] * levels, rect0=(0, 0, 0, 0),
                        )
                    )
                    cur_pid = pid
                t = templates[-1]
                # Blob rows are raw file order [x, y, label] -> (y, x, ori).
                fl = features[fo : fo + nf][:, [1, 0, 2]].copy()
                fo += nf
                t.size[level] = (h, w)
                if mod == 0:
                    t.grad[level] = fl
                else:
                    t.norm[level] = fl
            for t in templates:
                t.grad = [g for g in t.grad if g is not None]
                t.norm = [n for n in t.norm if n is not None]
                if t.size[0] != (0, 0):
                    t.rect0 = (0, 0, t.size[0][1], t.size[0][0])
            # class_id lives in a small header region; grab it cheaply.
            import gzip
            import re

            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                head = f.read(65536)
            m = re.search(r"class_id:\s*(\S+)", head)
            class_id = m.group(1) if m else "obj"
            return TemplateBank(class_id, params, templates, f_cap=f_cap)
        doc = oy.load(path)
        mods = {m["type"]: m for m in doc["modalities"]}
        cp = ModalityParams()
        dp = ModalityParams()
        if "ColorGradient" in mods:
            m = mods["ColorGradient"]
            cp.weak_threshold = float(m["weak_threshold"])
            cp.num_features = int(m["num_features"])
            cp.strong_threshold = float(m["strong_threshold"])
        if "DepthNormal" in mods:
            m = mods["DepthNormal"]
            dp.distance_threshold = float(m["distance_threshold"])
            dp.difference_threshold = float(m["difference_threshold"])
            dp.num_features = int(m["num_features"])
            dp.extract_threshold = int(m["extract_threshold"])
        params = DetectorParams(
            t_pyramid=tuple(doc["T"]),
            use_color_gradient="ColorGradient" in mods,
            use_depth_normal="DepthNormal" in mods,
            color=cp,
            depth=dp,
        )
        cls = doc["classes"][0]
        mod_names = list(cls.get("modalities", [m["type"] for m in doc["modalities"]]))
        n_mod = max(len(mod_names), 1)
        templates: list[TemplateFeatures] = []
        for pyr in cls["template_pyramids"]:
            grad: list[np.ndarray] = [None] * params.pyramid_levels  # type: ignore
            norm: list[np.ndarray] = [None] * params.pyramid_levels  # type: ignore
            size = [(0, 0)] * params.pyramid_levels
            for j, e in enumerate(pyr["templates"]):
                l = int(e["pyramid_level"])
                # OpenCV Feature::write order is [x, y, label]; internal rows
                # are (y, x, ori).
                fl = np.array(e["features"], np.int32).reshape(-1, 3)[:, [1, 0, 2]]
                size[l] = (int(e["height"]), int(e["width"]))
                # Template entries carry no modality name: the pyramid is the
                # flat list tp[level*num_modalities + modality_index]
                # (cv::linemod Detector::addTemplate layout).
                if mod_names[j % n_mod] == "ColorGradient":
                    grad[l] = fl
                else:
                    norm[l] = fl
            templates.append(
                TemplateFeatures(
                    grad=[g for g in grad if g is not None] if params.use_color_gradient else [],
                    norm=[n for n in norm if n is not None] if params.use_depth_normal else [],
                    size=size,
                    rect0=(0, 0, size[0][1], size[0][0]),
                )
            )
        return TemplateBank(cls["class_id"], params, templates, f_cap=f_cap)
