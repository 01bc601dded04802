"""Differentiable-free JAX triangle rasterizer for STL meshes.

Device replacement for ORK's offscreen-OpenGL Renderer3d (SURVEY.md
section 2.2 E2): renders depth (mm), binary mask, flat-shaded RGB and the
tight mask bbox for a camera pose at given intrinsics.  Used offline by the
view-sphere trainer (models/trainer.py, ref renderer.cpp:262-329) and online
inside the detection cascade's rough-pose stage (ref
rgbdDetector::getRoughPoseByClustering re-render, rgbdDetector.cpp:712-721).

Conventions (matching the bank, see utils.geometry.look_at_object):
- R is the object->camera rotation ("R" in renderer_params.yml), camera eye
  at -T (bank "T" = negative camera position), X_cam = R @ (X + T).
- OpenCV pixel convention: x right, y down, z forward; principal point at
  (W/2, H/2) like the reference trainer (renderer.cpp:295).
- Outputs are in *camera* convention (the reference renders GL-flipped and
  every caller immediately flips back — we skip the double flip).

Rasterization: z-buffer via a `lax.scan` over triangle chunks; each chunk
evaluates edge functions for all pixels at once (vectorized)
and min-reduces depth.  Static shapes throughout; batchable over poses with
`vmap` for the trainer.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class RenderOutput(NamedTuple):
    depth_mm: jnp.ndarray  # (H, W) float32 depth in millimeters, 0 = background
    mask: jnp.ndarray  # (H, W) uint8 {0, 255}
    rgb: jnp.ndarray  # (H, W, 3) uint8 flat-shaded
    rect: jnp.ndarray  # (4,) int32 (x, y, w, h) tight mask bbox; zeros if empty


def _pad_triangles(tris: np.ndarray, chunk: int) -> np.ndarray:
    T = tris.shape[0]
    pad = (-T) % chunk
    if pad:
        # Degenerate far-away triangles never rasterize.
        filler = np.full((pad, 3, 3), 1e5, dtype=np.float32)
        tris = np.concatenate([tris, filler], axis=0)
    return tris


@partial(jax.jit, static_argnames=("width", "height", "chunk"))
def render(
    triangles: jnp.ndarray,
    R: jnp.ndarray,
    T_bank: jnp.ndarray,
    K: jnp.ndarray,
    width: int,
    height: int,
    chunk: int = 64,
    coverage_grow: float = 0.5,
) -> RenderOutput:
    """Rasterize `triangles` (Tn, 3, 3 — pad count to a multiple of `chunk`)
    under pose (R, T_bank) and intrinsics K.

    `coverage_grow` dilates triangle coverage by that many pixels of signed
    edge distance (conservative rasterization).  The reference's GL
    renderer produces masks ~1 px fatter per side than exact center
    sampling (the shipped bank's Rects are consistently x+1/w+2/h+2 vs our
    exact silhouette); 0.5 px of growth reproduces its bounding boxes."""
    Tn = triangles.shape[0]
    assert Tn % chunk == 0, "pad triangle count to a multiple of chunk"
    # Object -> camera.
    v_cam = (triangles + T_bank[None, None, :]) @ R.T  # (Tn, 3, 3)

    # Perspective projection to pixel coords.
    z = v_cam[..., 2]
    eps = 1e-9
    u = K[0, 0] * v_cam[..., 0] / jnp.maximum(z, eps) + K[0, 2]
    v = K[1, 1] * v_cam[..., 1] / jnp.maximum(z, eps) + K[1, 2]
    behind = jnp.any(z <= 1e-6, axis=-1)  # skip triangles crossing the camera

    # Face normals in camera frame for shading.
    n = jnp.cross(v_cam[:, 1] - v_cam[:, 0], v_cam[:, 2] - v_cam[:, 0])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    shade = jnp.abs(n[:, 2])  # headlight

    px = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1) + 0.5
    py = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0) + 0.5

    def rasterize_chunk(carry, tri_idx0):
        zbuf, sbuf = carry
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, tri_idx0, chunk, axis=0)
        uu, vv, zz = sl(u), sl(v), sl(z)
        sh = sl(shade)
        skip = sl(behind)

        x0, y0 = uu[:, 0, None, None], vv[:, 0, None, None]
        x1, y1 = uu[:, 1, None, None], vv[:, 1, None, None]
        x2, y2 = uu[:, 2, None, None], vv[:, 2, None, None]

        # Edge functions (twice signed area of sub-triangles).
        w0 = (x2 - x1) * (py[None] - y1) - (y2 - y1) * (px[None] - x1)
        w1 = (x0 - x2) * (py[None] - y2) - (y0 - y2) * (px[None] - x2)
        w2 = (x1 - x0) * (py[None] - y0) - (y1 - y0) * (px[None] - x0)
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # (chunk, 1, 1)

        # Conservative coverage: w/len is the signed pixel distance to the
        # edge, so growing by g pixels accepts w >= -g*len (mirrored for
        # negative-orientation triangles).
        g = coverage_grow
        l0 = jnp.hypot(x2 - x1, y2 - y1)
        l1 = jnp.hypot(x0 - x2, y0 - y2)
        l2 = jnp.hypot(x1 - x0, y1 - y0)
        pos = (w0 >= -g * l0) & (w1 >= -g * l1) & (w2 >= -g * l2)
        neg = (w0 <= g * l0) & (w1 <= g * l1) & (w2 <= g * l2)
        # Clamp growth to the triangle's own (grown) bbox: sliver/edge-on
        # triangles' three edge lines nearly coincide, and the +-g band
        # around that line would otherwise paint a full-image stripe.
        xmin = jnp.minimum(jnp.minimum(x0, x1), x2) - g
        xmax = jnp.maximum(jnp.maximum(x0, x1), x2) + g
        ymin = jnp.minimum(jnp.minimum(y0, y1), y2) - g
        ymax = jnp.maximum(jnp.maximum(y0, y1), y2) + g
        inb = (px[None] >= xmin) & (px[None] <= xmax) & (py[None] >= ymin) & (py[None] <= ymax)
        inside = (pos | neg) & inb
        ok = inside & (jnp.abs(area) > 1e-12) & (~skip[:, None, None])

        # Perspective-correct depth: interpolate 1/z with barycentrics.
        a = jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
        b0, b1, b2 = w0 / a, w1 / a, w2 / a
        inv_z = (
            b0 * (1.0 / jnp.maximum(zz[:, 0, None, None], 1e-9))
            + b1 * (1.0 / jnp.maximum(zz[:, 1, None, None], 1e-9))
            + b2 * (1.0 / jnp.maximum(zz[:, 2, None, None], 1e-9))
        )
        # Grown pixels extrapolate barycentrics slightly outside the
        # triangle; clamp the interpolated depth to the triangle's own z
        # range (an extrapolated closer-than-the-triangle depth would
        # corrupt the z-buffer) and treat non-positive 1/z as a miss.
        ztri_min = jnp.min(zz, axis=1)[:, None, None]
        ztri_max = jnp.max(zz, axis=1)[:, None, None]
        zpix = jnp.clip(1.0 / jnp.maximum(inv_z, 1e-9), ztri_min, ztri_max)
        zpix = jnp.where(ok & (inv_z > 1e-9), zpix, jnp.inf)

        # Min-depth over the chunk, then merge into the carry z-buffer.
        best = jnp.argmin(zpix, axis=0)
        zmin = jnp.min(zpix, axis=0)
        smin = jnp.take_along_axis(sh[:, None, None] * jnp.ones_like(zpix), best[None], axis=0)[0]
        closer = zmin < zbuf
        zbuf = jnp.where(closer, zmin, zbuf)
        sbuf = jnp.where(closer, smin, sbuf)
        return (zbuf, sbuf), None

    zbuf0 = jnp.full((height, width), jnp.inf, jnp.float32)
    sbuf0 = jnp.zeros((height, width), jnp.float32)
    starts = jnp.arange(0, Tn, chunk, dtype=jnp.int32)
    (zbuf, sbuf), _ = jax.lax.scan(rasterize_chunk, (zbuf0, sbuf0), starts)
    return _postprocess(zbuf, sbuf, width, height)


def _postprocess(zbuf: jnp.ndarray, sbuf: jnp.ndarray, width: int,
                 height: int) -> RenderOutput:
    """z/shade buffers -> depth_mm, mask, flat-shaded rgb, tight bbox."""
    hit = jnp.isfinite(zbuf)
    depth_mm = jnp.where(hit, zbuf * 1000.0, 0.0)
    mask = jnp.where(hit, jnp.uint8(255), jnp.uint8(0))
    gray = jnp.clip(60.0 + 180.0 * sbuf, 0, 255).astype(jnp.uint8)
    rgb = jnp.where(hit[..., None], gray[..., None], jnp.uint8(0))
    rgb = jnp.broadcast_to(rgb, (height, width, 3))

    # Tight bbox of the mask.
    cols = jnp.any(hit, axis=0)
    rows = jnp.any(hit, axis=1)
    ci = jnp.arange(width, dtype=jnp.int32)
    ri = jnp.arange(height, dtype=jnp.int32)
    any_hit = jnp.any(hit)
    x0 = jnp.min(jnp.where(cols, ci, width))
    x1 = jnp.max(jnp.where(cols, ci, -1))
    y0 = jnp.min(jnp.where(rows, ri, height))
    y1 = jnp.max(jnp.where(rows, ri, -1))
    rect = jnp.where(
        any_hit,
        jnp.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1]),
        jnp.zeros(4, jnp.int32),
    ).astype(jnp.int32)
    return RenderOutput(depth_mm, mask, rgb, rect)


class Renderer:
    """Host-facing convenience wrapper holding a padded device mesh.

    The analog of the reference's Renderer3d + set_parameters
    (renderer.cpp:239-242): construct from an STL path/mesh and intrinsics,
    then call `.render(R, T)` (targeted re-render, cf. renderDepthOnly /
    renderImageOnly at rgbdDetector.cpp:720-721) or batch over poses.
    """

    def __init__(self, mesh_or_path, width: int, height: int, fx: float, fy: float,
                 near: float = 0.1, far: float = 1000.0, chunk: int = 64):
        from ..utils.stl import Mesh, load_stl

        mesh = load_stl(mesh_or_path) if isinstance(mesh_or_path, str) else mesh_or_path
        self.width, self.height = width, height
        self.near, self.far = near, far
        self.chunk = chunk
        self.K = jnp.array(
            [[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]], jnp.float32
        )
        tris = _pad_triangles(mesh.triangles.astype(np.float32), chunk)
        self.triangles = jnp.asarray(tris)
        # Build the batched entry ONCE: constructing a fresh vmap closure per
        # call re-traces the whole scan body; a cached jit retraces only on
        # new batch shapes.  Triangles/K are arguments, not closure captures, so
        # the lowered HLO carries no mesh-sized constants.
        self._batch_fn = jax.jit(
            jax.vmap(
                lambda tris, R, T, K: render(
                    tris, R, T, K, self.width, self.height, self.chunk
                ),
                in_axes=(None, 0, 0, None),
            )
        )

    def render(self, R, T_bank) -> RenderOutput:
        return render(
            self.triangles, jnp.asarray(R, jnp.float32), jnp.asarray(T_bank, jnp.float32),
            self.K, self.width, self.height, self.chunk,
        )

    def render_batch(self, Rs, Ts) -> RenderOutput:
        return self._batch_fn(
            self.triangles,
            jnp.asarray(Rs, jnp.float32),
            jnp.asarray(Ts, jnp.float32),
            self.K,
        )
