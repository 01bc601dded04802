"""Offline template trainer: STL -> view-sphere renders -> template bank.

The device-side replacement for the reference's renderer_node /
renderer_only_image_node (SURVEY.md C15/C16, renderer.cpp:170-354):

  for each view on the (radius x in-plane-angle x sphere-point) grid:
      render depth/mask/RGB at the view pose          [device, batched]
      extract LINEMOD features (gradient [+ normals]) [host]
      skip views with too few features (addTemplate == -1)
      record {R, T, K, D, Ori_dist, Rect} metadata
  write templates.yml + renderer_params.yml           [C14 formats]

RGB-only mode (`use_depth_normal=False`) corresponds to the Ensenso trainer
(renderer_only_image.cpp); RGB+Depth to the full renderer_node.  Rendering
is batched over views with vmap — the device does all views of a chunk in
one dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import features as FO
from ..utils.stl import load_stl
from ..utils.viewsphere import ViewSphereParams, generate_views
from .detector import Detector
from .renderer import Renderer
from .templates import (
    DetectorParams,
    RendererGlobals,
    TemplateBank,
    TemplateMetadata,
)


@dataclass
class TrainerConfig:
    view_sphere: ViewSphereParams = field(default_factory=ViewSphereParams)
    width: int = 640
    height: int = 480
    focal_length_x: float = 535.566011
    focal_length_y: float = 537.168115
    near: float = 0.1
    far: float = 1000.0
    detector: DetectorParams = field(default_factory=DetectorParams)
    render_batch: int = 16
    class_id: str = "obj"


@partial(jax.jit, static_argnames=(
    "weak_threshold", "dist_thresh", "diff_thresh", "use_depth", "levels",
    "crop",
))
def _featurize_batch(rgbs, depths, masks, rects, weak_threshold, dist_thresh,
                     diff_thresh, use_depth: bool, levels: int = 2,
                     crop: int = 288):
    """Quantize a whole render chunk in ONE device dispatch and return only
    fixed-size CROPS around each view's render rect, PACKED into one u8
    tensor + one f32 tensor per level plus one small meta array: every
    device<->host transfer pays a fixed latency, so the leaf COUNT (not
    bytes) dominates training time; thresholds are static for the same
    reason (a traced float is an upload per call).

    Per level l (side s = crop >> l):
      u8_l  (B, nu8, s, s): [grad quant, (norm quant), mask]
      f32_l (B, s, s):      gradient mag^2 (selection scores)
    meta (B, 3) f32: crop origin (cy0, cx0) and center depth.

    The quantizers run on the FULL frame first (identical numerics to the
    detection path — no crop-border artifacts), then the results crop.
    """
    H, W = rgbs.shape[1:3]

    def one(rgb, depth, mask, rect):
        # Crop origin: rect centered in the crop window, clamped in-frame.
        cx0 = jnp.clip(rect[0] + rect[2] // 2 - crop // 2, 0, max(W - crop, 0))
        cy0 = jnp.clip(rect[1] + rect[3] // 2 - crop // 2, 0, max(H - crop, 0))
        # Even origins so each level-l crop starts exactly at origin >> l
        # (level coordinates stay consistent across the pyramid).
        cx0 = (cx0 // (1 << (levels - 1))) * (1 << (levels - 1))
        cy0 = (cy0 // (1 << (levels - 1))) * (1 << (levels - 1))
        u8_levels, f32_levels = [], []
        center_depth = depth[H // 2, W // 2]
        cur = rgb.astype(jnp.float32)
        # Depth quantizes ONCE at full resolution; coarser levels subsample
        # the level-0 quantized normals (DepthNormalPyramid::pyrDown
        # semantics — probed bit-exact against the genuine engine).
        cur_qd = (
            FO.quantize_depth_normal(depth, dist_thresh, diff_thresh)
            if use_depth else None
        )
        cur_m = mask
        for l in range(levels):
            s = crop >> l
            oy, ox = cy0 >> l, cx0 >> l
            q, m2 = FO.quantize_color_gradient(cur, weak_threshold)
            planes = [jax.lax.dynamic_slice(q, (oy, ox), (s, s))]
            if use_depth:
                planes.append(jax.lax.dynamic_slice(cur_qd, (oy, ox), (s, s)))
            planes.append(
                jax.lax.dynamic_slice(cur_m, (oy, ox), (s, s)).astype(jnp.uint8)
            )
            u8_levels.append(jnp.stack(planes, axis=0))
            f32_levels.append(jax.lax.dynamic_slice(m2, (oy, ox), (s, s)))
            if l + 1 < levels:
                cur = jnp.stack(
                    [FO.pyr_down(cur[..., c]) for c in range(cur.shape[-1])],
                    axis=-1,
                )
                if use_depth:
                    cur_qd = cur_qd[::2, ::2]
                cur_m = cur_m[::2, ::2]
        meta = jnp.stack([
            cy0.astype(jnp.float32), cx0.astype(jnp.float32), center_depth,
        ])
        return {"u8": u8_levels, "f32": f32_levels, "meta": meta}

    return jax.vmap(one)(rgbs, depths, masks, rects)


def train_from_stl(
    stl_path: str,
    config: TrainerConfig | None = None,
    max_views: int | None = None,
    progress: bool = False,
) -> tuple[Detector, TemplateBank]:
    """The renderer_node main loop (renderer.cpp:262-329), batched.
    `stl_path` may also be a loaded utils.stl.Mesh."""
    cfg = config or TrainerConfig()
    mesh = load_stl(stl_path) if isinstance(stl_path, str) else stl_path
    r = Renderer(
        mesh, cfg.width, cfg.height, cfg.focal_length_x, cfg.focal_length_y,
        cfg.near, cfg.far,
    )
    views = generate_views(cfg.view_sphere)
    if max_views is not None:
        views = views[:max_views]

    det = Detector(cfg.detector)
    Rs, Ts, Ks, Ds, Ods, Rects = [], [], [], [], [], []

    K_np = np.array(
        [
            [cfg.focal_length_x, 0, cfg.width / 2.0],
            [0, cfg.focal_length_y, cfg.height / 2.0],
            [0, 0, 1.0],
        ],
        np.float32,
    )

    B = cfg.render_batch
    dp = cfg.detector
    CROP = min(288, cfg.width, cfg.height)

    def _dispatch(chunk):
        """Render + featurize one chunk on device and start the async
        device->host copies; returns without blocking so the next chunk's
        device work and DMA overlap the current chunk's host extraction."""
        # One upload per chunk: R and T ride together.  The last (short)
        # chunk pads to the full batch by repeating its final view — a
        # different batch shape would retrace render+featurize (~90 s of
        # remote XLA compile for a dozen views); hosts drop the pad rows.
        pad = [chunk[-1]] * (B - len(chunk))
        RT = jnp.asarray(np.stack(
            [np.concatenate([v.R.astype(np.float32),
                             v.T.astype(np.float32)[None]], axis=0)
             for v in list(chunk) + pad]
        ))
        out = r.render_batch(RT[:, :3], RT[:, 3])
        feat = _featurize_batch(
            out.rgb, out.depth_mm.astype(jnp.float32), out.mask, out.rect,
            dp.color.weak_threshold, dp.depth.distance_threshold,
            dp.depth.difference_threshold,
            use_depth=dp.use_depth_normal, levels=dp.pyramid_levels,
            crop=CROP,
        )
        for leaf in jax.tree.leaves(feat) + [out.rect]:
            try:
                leaf.copy_to_host_async()
            except AttributeError:  # pragma: no cover - non-array leaf
                pass
        return out, feat

    chunks = [views[s : s + B] for s in range(0, len(views), B)]
    pending = _dispatch(chunks[0]) if chunks else None
    for ci, chunk in enumerate(chunks):
        out, feat = pending
        if ci + 1 < len(chunks):
            pending = _dispatch(chunks[ci + 1])
        feat = jax.tree.map(np.asarray, feat)
        rect = np.asarray(out.rect)
        start = ci * B
        meta_np = feat["meta"]  # (B, 3): cy0, cx0, center_depth
        margin = 12  # blur/Sobel/vote support around the mask

        for j, v in enumerate(chunk):
            if rect[j, 2] == 0 or rect[j, 3] == 0:
                continue  # nothing rendered (is_image_valid == false)
            if rect[j, 2] > CROP - 2 * margin or rect[j, 3] > CROP - 2 * margin:
                # Object larger than the crop window: full-frame fallback
                # (transfers this view's frame on demand; rare).
                tid = det.add_template(
                    np.asarray(out.rgb[j]),
                    np.asarray(out.mask[j]),
                    cfg.class_id,
                    depth_mm=(np.asarray(out.depth_mm[j])
                              if dp.use_depth_normal else None),
                )
            else:
                pre = {
                    "grad": [(u8[j, 0], m2[j])
                             for u8, m2 in zip(feat["u8"], feat["f32"])],
                    "norm": ([u8[j, 1] for u8 in feat["u8"]]
                             if dp.use_depth_normal else []),
                }
                tid = det.add_template(
                    np.zeros((CROP, CROP, 3), np.uint8),  # unused with `pre`
                    feat["u8"][0][j, -1],
                    cfg.class_id,
                    depth_mm=(np.zeros((CROP, CROP), np.uint16)
                              if dp.use_depth_normal else None),
                    precomputed=pre,
                )
                if tid >= 0:
                    # rect0 is crop-local; re-base to full-frame coords.
                    t = det._templates[cfg.class_id][tid]
                    x0, y0, w0, h0 = t.rect0
                    t.rect0 = (x0 + int(meta_np[j, 1]), y0 + int(meta_np[j, 0]),
                               w0, h0)
            if tid < 0:
                continue  # too few features -> skip view (renderer.cpp:308-315)
            # distance = D_obj - center surface depth (renderer.cpp:284-285)
            cd = float(meta_np[j, 2]) / 1000.0
            Rs.append(v.R)
            Ts.append(v.T)
            Ks.append(K_np)
            Ds.append(v.D_obj - float(cd))
            Ods.append(v.D_obj)
            Rects.append(rect[j])
        if progress:
            print(f"trained {det.num_templates(cfg.class_id)} / {start + len(chunk)} views")

    meta = TemplateMetadata(
        R=np.stack(Rs) if Rs else np.zeros((0, 3, 3)),
        T=np.stack(Ts) if Ts else np.zeros((0, 3)),
        K=np.stack(Ks) if Ks else np.zeros((0, 3, 3), np.float32),
        D=np.array(Ds),
        Ori_dist=np.array(Ods),
        Rect=np.stack(Rects).astype(np.int32) if Rects else np.zeros((0, 4), np.int32),
    )
    vs = cfg.view_sphere
    globals_ = RendererGlobals(
        n_points=vs.n_points,
        angle_step=vs.angle_step,
        radius_min=vs.radius_min,
        radius_max=vs.radius_max,
        radius_step=vs.radius_step,
        width=cfg.width,
        height=cfg.height,
        focal_length_x=cfg.focal_length_x,
        focal_length_y=cfg.focal_length_y,
        near=cfg.near,
        far=cfg.far,
    )
    bank = TemplateBank(
        cfg.class_id,
        cfg.detector,
        det._templates[cfg.class_id],
        metadata=meta,
        globals_=globals_,
    )
    det.attach_bank(bank)
    return det, bank


def train_and_write(
    stl_path: str,
    templates_yml: str,
    params_yml: str,
    config: TrainerConfig | None = None,
    max_views: int | None = None,
) -> tuple[Detector, TemplateBank]:
    """Full trainer entry: train + write both YAML banks
    (renderer.cpp:331-349)."""
    det, bank = train_from_stl(stl_path, config, max_views)
    bank.write_templates_yaml(templates_yml)
    bank.write_params_yaml(params_yml)
    return det, bank
