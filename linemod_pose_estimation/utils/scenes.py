"""Seeded bin-picking scenes for benchmarks and on-device checks.

Rendered views of the object planted (colour AND depth) on low-texture
backgrounds with flat distractor boxes, the scene family bench.py and
chip_smoke.py share.  Every scene is made from a numpy Generator, so a
seed reproduces it exactly.
"""

from __future__ import annotations

import numpy as np

BG_MM = 1500.0  # background depth


def bin_picking_scenes(renderer, meta, B: int, H: int, W: int,
                       rng: np.random.Generator, n_objects: int = 2,
                       n_views: int = 64):
    """B (H, W) RGB-D scenes, each holding `n_objects` views drawn from the
    bank's first `n_views` poses (meta.R / meta.T) over three flat
    distractors.  Returns (frames (B, H, W, 3) uint8, depths (B, H, W)
    float32 mm, truths: per frame a list of (view id, x, y) of each
    planted view's mask bbox corner)."""
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.zeros((B, H, W, 3), np.uint8)
    depths = np.zeros((B, H, W), np.float32)
    truths = []
    n_meta = meta.R.shape[0]
    views = {}
    for b in range(B):
        bg = (40 + 60 * yy / H + 30 * np.sin(xx / 200.0)).astype(np.uint8)
        fr = np.stack([bg, (bg * 0.9).astype(np.uint8),
                       (bg * 1.1).clip(0, 255).astype(np.uint8)], -1)
        dp = np.full((H, W), BG_MM, np.float32)
        for _ in range(3):
            y0, x0 = int(rng.integers(0, H - 80)), int(rng.integers(0, W - 120))
            fr[y0:y0 + 80, x0:x0 + 120] = rng.integers(60, 160, size=3)
            dp[y0:y0 + 80, x0:x0 + 120] = float(rng.uniform(1200, 1800))
        planted = []
        for _ in range(n_objects):
            vid = int(rng.integers(0, min(n_meta, n_views)))
            if vid not in views:
                out = renderer.render(meta.R[vid], meta.T[vid])
                views[vid] = (np.asarray(out.rgb), np.asarray(out.depth_mm),
                              np.asarray(out.mask) > 0,
                              [int(v) for v in np.asarray(out.rect)])
            rgb, vdep, mask, (x, y, w, h) = views[vid]
            dy = int(rng.integers(-y, H - (y + h)))
            dx = int(rng.integers(-x, W - (x + w)))
            sub = mask[y:y + h, x:x + w]
            tgt = np.s_[y + dy:y + dy + h, x + dx:x + dx + w]
            fr[tgt][sub] = rgb[y:y + h, x:x + w][sub]
            dp[tgt][sub] = vdep[y:y + h, x:x + w][sub].astype(np.float32)
            planted.append((vid, x + dx, y + dy))
        frames[b], depths[b] = fr, dp
        truths.append(planted)
    return frames, depths, truths


def found_rate(matches, truths, tol: int = 8) -> tuple[int, int]:
    """(found, planted): planted views with a valid match within `tol` px
    of their bbox corner.  `matches` holds (B, K) arrays."""
    ok, total = 0, 0
    for b, pl in enumerate(truths):
        v = np.asarray(matches.valid[b])
        xs, ys = np.asarray(matches.x[b]), np.asarray(matches.y[b])
        for _vid, x, y in pl:
            total += 1
            ok += bool((v & (np.abs(xs - x) <= tol)
                        & (np.abs(ys - y) <= tol)).any())
    return ok, total
