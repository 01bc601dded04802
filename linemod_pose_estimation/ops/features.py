"""Quantized LINEMOD modalities: the front half of the cv::linemod engine
(SURVEY.md section 2.2 E1), as vectorized JAX ops.

Pipeline per frame (all static shapes, jit/vmap-friendly):

  rgb ──gaussian_blur7──sobel3──► strongest-channel gradient
      ──quantize to 8 orientation bins (16 folded) ──hysteresis 3x3 vote──►
      quantized bitmask u8 (one-hot 1<<bin, 0 = no orientation)

  depth ──masked LS plane fit over the 8 radius-5 neighbours──► (ddx, ddy)
        ──azimuth quantize to 8 sectors (phase-0 round)──► quantized bitmask u8

  bitmask ──orientation_spread (TxT OR-dilation)──► spread mask
          ──response_maps (max-cosine LUT)──► R[8, H, W] u8 in 0..4

Numeric conventions follow OpenCV's ColorGradient / DepthNormal modalities:
7x7 Gaussian (fixed small-kernel taps), 3x3 Sobel with reflect-101 borders,
squared-magnitude thresholds, 16->8 orientation folding, 3x3 neighbourhood
vote with >= 5 agreement, spread offsets in [0, T), and the graded
4/3/2/1/0 circular-distance response table (SIMILARITY_LUT).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# OpenCV getGaussianKernel fixed taps for ksize=7 (sigma<=0).
_GAUSS7 = jnp.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
                    dtype=jnp.float32)

NUM_ORIENTATIONS = 8
# Response by circular bin distance d in [0, 4]: score = 4 - d.  This is
# OpenCV's SIMILARITY_LUT grading (linemod.cpp computeResponseMaps): the
# per-orientation LUT blocks decode to max over set bits of
# (4 - circ_dist) — e.g. the ori-0 low-nibble block is
# {0,4,3,4,2,4,3,4,1,4,3,4,2,4,3,4}.
RESPONSE_BY_DISTANCE = (4, 3, 2, 1, 0)
RESPONSE_EXACT = RESPONSE_BY_DISTANCE[0]
RESPONSE_ADJACENT = RESPONSE_BY_DISTANCE[1]


def _reflect_pad2d(x: jnp.ndarray, p: int) -> jnp.ndarray:
    return jnp.pad(x, [(p, p), (p, p)], mode="reflect")


def _band_matrix(n_in: int, taps: jnp.ndarray) -> jnp.ndarray:
    """(n_in, n_in - k + 1) banded matrix B with B[j + i, j] = taps[k-1-i]
    (conv semantics: kernel flipped), so  x @ B  is the VALID 1-D conv."""
    k = int(taps.shape[0])
    n_out = n_in - k + 1
    rows = jax.lax.broadcasted_iota(jnp.int32, (n_in, n_out), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (n_in, n_out), 1)
    d = rows - cols  # tap index i in [0, k)
    flipped = jnp.asarray(np.asarray(taps)[::-1].copy(), jnp.float32)
    return jnp.where(
        (d >= 0) & (d < k), flipped[jnp.clip(d, 0, k - 1)], 0.0
    )


_CONV_TILE = 128  # block-banded tile width


def _conv1d_blocked(x32: jnp.ndarray, taps: jnp.ndarray, ax: int,
                    precision) -> jnp.ndarray:
    """Block-banded VALID conv: contract 1-D conv tiles as matmuls.

    A DENSE (n_in, n_out) band matrix costs n_in MACs per output for a
    k-tap filter (~90x waste at 640 px).  Tiling the output axis into
    128-wide blocks shrinks the contraction to (128 + k - 1) MACs per
    output — about 4x less work on the preprocess filter chain — while
    keeping results BIT-EXACT: the dropped entries are exact zeros, and
    f32 adds with 0.0 never round, so the surviving k products accumulate
    to the same value as in the dense formulation (the integer-valued
    exact path stays exact; see gaussian_blur7_u8).
    """
    k = int(taps.shape[0])
    n_in = x32.shape[ax]
    n_out = n_in - k + 1
    TB = _CONV_TILE
    nt = -(-n_out // TB)
    # Move the conv axis last for uniform handling.
    if ax != x32.ndim - 1:
        x32 = jnp.swapaxes(x32, ax, -1)
    pad = nt * TB + k - 1 - x32.shape[-1]
    xp = jnp.pad(x32, [(0, 0)] * (x32.ndim - 1) + [(0, pad)])
    tiles = jnp.stack(
        [jax.lax.slice_in_dim(xp, j * TB, j * TB + TB + k - 1, axis=-1)
         for j in range(nt)],
        axis=-2,
    )  # (..., nt, TB + k - 1)
    Bm = _band_matrix(TB + k - 1, taps)  # (TB + k - 1, TB)
    out = jax.lax.dot_general(
        tiles, Bm,
        dimension_numbers=(((tiles.ndim - 1,), (0,)), ((), ())),
        precision=precision,
    )  # (..., nt, TB)
    out = out.reshape(out.shape[:-2] + (nt * TB,))[..., :n_out]
    if ax != x32.ndim - 1:
        out = jnp.swapaxes(out, ax, -1)
    return out


def _band_matrix_dec2(TB: int, taps: jnp.ndarray) -> jnp.ndarray:
    """(2*TB + k - 2, TB) banded matrix for a VALID conv DECIMATED 2x:
    column c holds the flipped taps at rows 2c .. 2c + k - 1, so x @ Bd
    yields y[2c] of the full conv — the same k products and adds as the
    dense formulation (dropped entries are exact zeros), never computing
    the odd outputs at all."""
    k = int(taps.shape[0])
    n_in = 2 * TB + k - 2
    rows = jax.lax.broadcasted_iota(jnp.int32, (n_in, TB), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (n_in, TB), 1)
    d = rows - 2 * cols
    flipped = jnp.asarray(np.asarray(taps)[::-1].copy(), jnp.float32)
    return jnp.where(
        (d >= 0) & (d < k), flipped[jnp.clip(d, 0, k - 1)], 0.0
    )


def _conv1d_blocked_dec2(x32: jnp.ndarray, taps: jnp.ndarray, ax: int,
                         precision) -> jnp.ndarray:
    """Block-banded VALID conv + 2x decimation fused into the band matrix.

    Emitting only the even outputs from the contraction replaces a
    separate strided `out[::2]` slice and halves the MACs.  Bit-exact vs _conv1d_blocked(...)[::2] (same taps, same adds)."""
    k = int(taps.shape[0])
    n_in = x32.shape[ax]
    n_out = (n_in - k) // 2 + 1  # ceil of (n_in - k + 1) / 2
    TB = _CONV_TILE
    nt = -(-n_out // TB)
    if ax != x32.ndim - 1:
        x32 = jnp.swapaxes(x32, ax, -1)
    pad = 2 * nt * TB + k - 2 - x32.shape[-1]
    xp = jnp.pad(x32, [(0, 0)] * (x32.ndim - 1) + [(0, max(pad, 0))])
    tiles = jnp.stack(
        [jax.lax.slice_in_dim(xp, 2 * j * TB, 2 * j * TB + 2 * TB + k - 2,
                              axis=-1)
         for j in range(nt)],
        axis=-2,
    )  # (..., nt, 2*TB + k - 2)
    Bm = _band_matrix_dec2(TB, taps)
    out = jax.lax.dot_general(
        tiles, Bm,
        dimension_numbers=(((tiles.ndim - 1,), (0,)), ((), ())),
        precision=precision,
    )  # (..., nt, TB)
    out = out.reshape(out.shape[:-2] + (nt * TB,))[..., :n_out]
    if ax != x32.ndim - 1:
        out = jnp.swapaxes(out, ax, -1)
    return out


def _conv1d(x: jnp.ndarray, taps: jnp.ndarray, axis: int) -> jnp.ndarray:
    """VALID 1-D convolution of (..., H, W) along `axis` (one of the last two
    dims) as a block-banded matrix contraction (a few small matmuls, cheap
    to compile), in full float32: HIGHEST keeps GPU matmuls off TF32, whose
    10-bit mantissa would round the filter inputs."""
    ax = x.ndim - 2 + axis
    return _conv1d_blocked(
        x.astype(jnp.float32), taps, ax, jax.lax.Precision.HIGHEST
    )


def gaussian_blur7(img: jnp.ndarray) -> jnp.ndarray:
    """Separable 7x7 Gaussian on (H, W) float32, reflect-101 borders."""
    x = _reflect_pad2d(img.astype(jnp.float32), 3)
    # Conv flips the kernel; the taps are symmetric so correlation == conv.
    return _conv1d(_conv1d(x, _GAUSS7, 1), _GAUSS7, 0)


_SMOOTH131 = jnp.array([1.0, 2.0, 1.0], jnp.float32)
_DERIV101 = jnp.array([1.0, 0.0, -1.0], jnp.float32)  # conv-flipped [-1,0,1]


def sobel3(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 Sobel dx, dy on (H, W) float32, reflect-101 borders."""
    x = _reflect_pad2d(img.astype(jnp.float32), 1)
    dx = _conv1d(_conv1d(x, _DERIV101, 1), _SMOOTH131, 0)
    dy = _conv1d(_conv1d(x, _SMOOTH131, 1), _DERIV101, 0)
    return dx, dy


# cv::fastAtan2 polynomial constants: the double coefficient is truncated to
# float FIRST, then multiplied by (float)(180/pi) in float — replicated here
# digit-for-digit so angles match the genuine engine bit-for-bit.
_RAD2DEG_F = np.float32(180.0 / np.pi)
_ATAN_P1 = np.float32(np.float32(0.9997878412794807) * _RAD2DEG_F)
_ATAN_P3 = np.float32(np.float32(-0.3258083974640975) * _RAD2DEG_F)
_ATAN_P5 = np.float32(np.float32(0.1555786518463281) * _RAD2DEG_F)
_ATAN_P7 = np.float32(np.float32(-0.04432655554792128) * _RAD2DEG_F)
_DBL_EPS_F = np.float32(2.220446049250313e-16)


def fast_atan2_deg(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """cv::fastAtan2 (hal fastAtan32f), elementwise in f32: degrees in
    [0, 360).  Same polynomial, constants, and operation order as OpenCV, so
    the quantized orientation matches the real engine bit-for-bit."""
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    ax, ay = jnp.abs(x), jnp.abs(y)
    big = ax >= ay
    num = jnp.where(big, ay, ax)
    den = jnp.where(big, ax, ay) + _DBL_EPS_F
    c = num / den
    c2 = c * c
    a = (((_ATAN_P7 * c2 + _ATAN_P5) * c2 + _ATAN_P3) * c2 + _ATAN_P1) * c
    a = jnp.where(big, a, jnp.float32(90.0) - a)
    a = jnp.where(x < 0, jnp.float32(180.0) - a, a)
    a = jnp.where(y < 0, jnp.float32(360.0) - a, a)
    return a


# Integer Q6 taps of OpenCV's fixed 7-tap small-sigma Gaussian
# ([1/32, 7/64, 7/32, 9/32, ...] * 64) — all products/sums below 2^24 stay
# exact in f32 banded matmuls at HIGHEST precision.
_GAUSS7_Q6 = jnp.array([2.0, 7.0, 14.0, 18.0, 14.0, 7.0, 2.0], jnp.float32)


def _replicate_pad2d(x: jnp.ndarray, p: int) -> jnp.ndarray:
    return jnp.pad(x, [(p, p), (p, p)], mode="edge")


def _conv1d_exact(x: jnp.ndarray, taps: jnp.ndarray, axis: int) -> jnp.ndarray:
    """VALID 1-D conv like _conv1d but at HIGHEST precision: with integer
    taps and integer-valued f32 inputs the result is exact integer f32
    (block-banding preserves that — every dropped term is an exact 0.0)."""
    ax = x.ndim - 2 + axis
    return _conv1d_blocked(
        x.astype(jnp.float32), taps, ax, jax.lax.Precision.HIGHEST
    )


def gaussian_blur7_u8(img: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact cv::GaussianBlur(8U, 7x7, sigma 0, BORDER_REPLICATE):
    exact-rational separable filter (Q6 integer taps, one Q12 accumulator)
    rounded half-up to u8 at the end — OpenCV's fixed-point 8U path keeps
    full precision through the separable passes and rounds once."""
    x = _replicate_pad2d(img.astype(jnp.float32), 3)
    acc = _conv1d_exact(_conv1d_exact(x, _GAUSS7_Q6, 1), _GAUSS7_Q6, 0)
    return jnp.floor((acc + 2048.0) * (1.0 / 4096.0))


def sobel3_replicate(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 Sobel dx, dy (CV_16S semantics, BORDER_REPLICATE) on integer-
    valued f32 input; exact integer results."""
    x = _replicate_pad2d(img.astype(jnp.float32), 1)
    dx = _conv1d_exact(_conv1d_exact(x, _DERIV101, 1), _SMOOTH131, 0)
    dy = _conv1d_exact(_conv1d_exact(x, _SMOOTH131, 1), _DERIV101, 0)
    return dx, dy


def quantize_color_gradient(
    rgb: jnp.ndarray, weak_threshold: float = 10.0
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(H, W, C) uint8/float image -> (quantized bitmask u8, magnitude^2).

    BIT-EXACT replica of OpenCV ColorGradient::quantizedOrientations +
    hysteresisGradient (linemod.cpp): u8-rounded 7x7 Gaussian and 3x3 Sobel
    with BORDER_REPLICATE, per-pixel strongest-channel select (first channel
    wins ties, memory order), cv::fastAtan2 polynomial angles, half-even
    convertTo into 16 bins folded to 8, 1-px border zeroing, then the 3x3
    hysteresis vote (center magnitude^2 > weak_threshold^2, >= 5 of 9
    agreement, first-max bin wins).  Verified bit-identical against the
    genuine libopencv_rgbd engine in tests/test_oracle_parity.py."""
    img = rgb.astype(jnp.float32)
    if img.ndim == 2:
        img = img[..., None]
    C = img.shape[-1]
    dxs, dys, mags = [], [], []
    for c in range(C):
        ch = gaussian_blur7_u8(img[..., c])
        dx, dy = sobel3_replicate(ch)
        dxs.append(dx)
        dys.append(dy)
        mags.append(dx * dx + dy * dy)
    # Strongest channel per pixel WITHOUT gathers: a where-chain with
    # first-max-wins tie-breaking (OpenCV's channel-order if/else) fuses
    # into one elementwise pass.
    mag2 = mags[0]
    for m in mags[1:]:
        mag2 = jnp.maximum(mag2, m)
    dx, dy = dxs[-1], dys[-1]
    for c in range(C - 2, -1, -1):
        hit = mags[c] == mag2
        dx = jnp.where(hit, dxs[c], dx)
        dy = jnp.where(hit, dys[c], dy)

    angle = fast_atan2_deg(dy, dx)
    # convertTo(CV_8U, 16/360): float scale, round half to even, then the
    # &15 wrap (16 -> 0) and the 16->8 fold (&7).
    bin8 = (
        jnp.round(angle * np.float32(16.0 / 360.0)).astype(jnp.int32) & 15
    ) & 7

    weak2 = np.float32(weak_threshold) * np.float32(weak_threshold)
    strong_px = mag2 > weak2

    # hysteresisGradient zeroes the 1-px border of the unfiltered bins BEFORE
    # the vote — border pixels vote as bin 0 (replicated faithfully).
    H, W = bin8.shape
    interior = jnp.zeros((H, W), bool).at[1:-1, 1:-1].set(True)
    bin8 = jnp.where(interior, bin8, 0)

    # 3x3 vote: one-hot planes box-filtered (9 static shifted adds);
    # all 9 neighbours vote with their unfiltered quantized bin.
    onehot = (bin8[None] == jnp.arange(8, dtype=jnp.int32)[:, None, None]).astype(
        jnp.int32
    )
    oh_p = jnp.pad(onehot, [(0, 0), (1, 1), (1, 1)])
    votes = None
    for r in range(3):
        for c in range(3):
            s = oh_p[:, r : r + H, c : c + W]
            votes = s if votes is None else votes + s  # (8, H, W)
    max_votes = jnp.max(votes, axis=0)
    win = jnp.argmax(votes, axis=0)
    ok = strong_px & (max_votes >= 5) & interior
    quant = jnp.where(ok, (1 << win).astype(jnp.uint8), jnp.uint8(0))
    return quant, mag2


_NORMAL_G = 10  # GRANULARITY of the engine's normal LUT (probed)
_NORMAL_LUT_CACHE: np.ndarray | None = None
_NORMAL_PATCH_CACHE: tuple[np.ndarray, np.ndarray] | None = None


def _normal_lut_table() -> np.ndarray:
    """The engine's (11, 21, 21) NORMAL_LUT over truncated-discretized
    normalized (nz, ny, nx), reconstructed by BLACK-BOX probing of the
    genuine cv::linemod DepthNormal quantizer (tools/probe_normal_lut.py;
    zero conflicts over ~85k probe images).  Cells the probe never reached
    (off the unit-sphere shell — unreachable at runtime, where inputs are
    always normalized) carry the azimuth-sector fallback
    round(atan2(v2-G, v1-G) * 8/2pi) that the probed cells follow."""
    global _NORMAL_LUT_CACHE
    if _NORMAL_LUT_CACHE is None:
        import os

        path = os.path.join(os.path.dirname(__file__), "normal_lut_calib.npz")
        with np.load(path) as z:
            _NORMAL_LUT_CACHE = z["lut"].astype(np.uint8)
    return _NORMAL_LUT_CACHE


def _normal_lut_patches() -> tuple[np.ndarray, np.ndarray]:
    """(flat_cell_ids, values) where the probed LUT deviates from the
    azimuth-sector rule — 74 cells, almost all on the degenerate nz == 0
    row.  The runtime lookup computes the azimuth rule arithmetically and
    overrides these cells with fused equality-selects (74 fused compares
    in place of a gather from the 4851-entry table)."""
    global _NORMAL_PATCH_CACHE
    if _NORMAL_PATCH_CACHE is None:
        lut = _normal_lut_table()
        G = _NORMAL_G
        az = np.arctan2(np.arange(21)[:, None] - G, np.arange(21)[None, :] - G)
        fb = (1 << (np.round(az * (8 / (2 * np.pi))).astype(np.int32) % 8))
        dev = lut != fb[None].astype(np.uint8)
        zz, yy, xx = np.nonzero(dev)
        flat = (zz * 21 + yy) * 21 + xx
        _NORMAL_PATCH_CACHE = (flat.astype(np.int32), lut[dev])
    return _NORMAL_PATCH_CACHE


def _median5_bitmask(q: jnp.ndarray) -> jnp.ndarray:
    """cv::medianBlur(q, 5) on the quantized-normal u8 image, replicate
    border: the true 13th-smallest of the 25-window.  A counting pass over
    the 9 one-hot values is NOT enough — the engine's NORMAL_LUT emits
    arbitrary (deterministic) bytes on its degenerate nz==0 row, so the
    median must rank the raw u8 values.  Bitwise MSB-first majority radix:
    8 passes, each narrowing the candidate set by whether >= 13 of the 25
    window values carry the current bit given the already-fixed prefix."""
    H, W = q.shape
    p = jnp.pad(q, 2, mode="edge")
    wins = [
        jax.lax.dynamic_slice(p, (r, c), (H, W)).astype(jnp.int32)
        for r in range(5) for c in range(5)
    ]
    med = jnp.zeros((H, W), jnp.int32)
    for bit in range(7, -1, -1):
        probe = med | (1 << bit)
        cnt = jnp.zeros((H, W), jnp.int32)
        for w in wins:
            cnt = cnt + (w >= probe)
        med = jnp.where(cnt >= 13, probe, med)
    return med.astype(jnp.uint8)


def quantize_depth_normal(
    depth_mm: jnp.ndarray,
    distance_threshold: float = 2000.0,
    difference_threshold: float = 50.0,
    radius: int = 5,
) -> jnp.ndarray:
    """Depth (H, W) in mm (0 = invalid) -> quantized surface-normal bitmask,
    BIT-EXACT with cv::linemod's DepthNormal quantizedNormals (verified
    against the genuine engine over ~75k probe scenes plus randomized
    corpora, tests/test_oracle_parity.py).

    The replicated chain: integer bilateral-masked LS plane fit over the 8
    neighbours at radius 5 (depth deltas >= `difference_threshold` rejected
    with weight 0), UNNORMALIZED integer solution (ddx, ddy, det) -> f32
    normal (1150*ddx, 1150*ddy, -det*d) -> normalize -> truncate onto the
    GRANULARITY=10 grid -> NORMAL_LUT lookup (probed table) -> zero outside
    rows/cols [5, dim-6] (the engine's asymmetric loop bounds) -> 5x5
    median blur.  All arithmetic stays in the exact-integer range of f32
    (|b| <= 2e3, |ddx| <= 8e5, det <= 4e4), and the two values that exceed
    2^24 (1150*ddx, det*d) are single correctly-rounded f32 products —
    identical to the engine's static_cast<float>(long) of the exact
    integer.
    """
    d32 = depth_mm.astype(jnp.int32)  # CV_16U truncation semantics
    d = d32.astype(jnp.float32)
    H, W = d.shape
    r = radius
    pd = jnp.pad(d, [(r, r), (r, r)])

    offsets = [(-r, -r), (-r, 0), (-r, r), (0, -r), (0, r), (r, -r), (r, 0), (r, r)]
    A00 = jnp.zeros((H, W), jnp.float32)
    A01 = jnp.zeros((H, W), jnp.float32)
    A11 = jnp.zeros((H, W), jnp.float32)
    b0 = jnp.zeros((H, W), jnp.float32)
    b1 = jnp.zeros((H, W), jnp.float32)
    for oy, ox in offsets:
        nb = jax.lax.dynamic_slice(pd, (oy + r, ox + r), (H, W))
        delta = nb - d
        # accumBilateral: weight 1 iff |delta| < threshold; the engine does
        # NOT exclude zero-depth neighbours (delta = -d simply fails the
        # threshold for d >= 50 and contributes zero for d < 50).
        w = (jnp.abs(delta) < difference_threshold).astype(jnp.float32)
        u, v = float(ox), float(oy)
        A00 += w * (u * u)
        A01 += w * (u * v)
        A11 += w * (v * v)
        b0 += (w * u) * delta
        b1 += (w * v) * delta
    det = A00 * A11 - A01 * A01        # <= 4e4: exact in f32
    ddx = A11 * b0 - A01 * b1          # <= 8e5: exact in f32
    ddy = -A01 * b0 + A00 * b1
    nx = jnp.float32(1150.0) * ddx     # one correctly-rounded product
    ny = jnp.float32(1150.0) * ddy
    nz = -det * d
    sq = nx * nx + ny * ny + nz * nz   # engine's left-assoc f32 order
    sqr = jnp.sqrt(sq)
    inv = jnp.where(sqr > 0, jnp.float32(1.0) / jnp.maximum(sqr, 1e-30), 0.0)
    G = jnp.float32(_NORMAL_G)
    v1 = (nx * inv * G + G).astype(jnp.int32)  # trunc, as static_cast<int>
    v2 = (ny * inv * G + G).astype(jnp.int32)
    v3 = (nz * inv * G + G).astype(jnp.int32)
    # LUT lookup WITHOUT a gather (see _normal_lut_patches): the azimuth
    # rule computed arithmetically, plus 74 fused equality patches.
    az = jnp.arctan2((v2 - 10).astype(jnp.float32), (v1 - 10).astype(jnp.float32))
    b8 = jnp.round(az * jnp.float32(8.0 / (2.0 * np.pi))).astype(jnp.int32) % 8
    val = (jnp.uint8(1) << b8.astype(jnp.uint8)).astype(jnp.uint8)
    flat = (jnp.clip(v3, 0, 10) * 21 + jnp.clip(v2, 0, 20)) * 21 + jnp.clip(v1, 0, 20)
    p_flat, p_val = _normal_lut_patches()
    for fk, vk in zip(p_flat.tolist(), p_val.tolist()):
        val = jnp.where(flat == fk, jnp.uint8(vk), val)
    ok = (d < distance_threshold) & (sqr > 0)
    q = jnp.where(ok, val, jnp.uint8(0))
    # Engine loop bounds: rows/cols [l_r, dim - l_r - 1) — note the extra -1.
    border = jnp.zeros((H, W), bool).at[r:H - r - 1, r:W - r - 1].set(True)
    q = jnp.where(border, q, jnp.uint8(0))
    return _median5_bitmask(q)


def orientation_spread(quant: jnp.ndarray, T: int) -> jnp.ndarray:
    """OR-dilate the bitmask over the TxT neighbourhood of offsets [0, T).

    OpenCV `spread`: spread_quant(y, x) = OR of quant(y+r, x+c) for
    r, c in [0, T).
    """
    H, W = quant.shape
    p = jnp.pad(quant, [(0, T - 1), (0, T - 1)])
    out = jnp.zeros((H, W), jnp.uint8)
    for r in range(T):
        for c in range(T):
            out = out | jax.lax.dynamic_slice(p, (r, c), (H, W))
    return out


def distance_masks(o: int) -> list[int]:
    """Bitmasks of the orientation bins at circular distance 0..4 from o."""
    masks = []
    for d in range(5):
        m = (1 << ((o - d) % 8)) | (1 << ((o + d) % 8))
        masks.append(m)
    return masks


def response_maps(spread_quant: jnp.ndarray) -> jnp.ndarray:
    """Spread bitmask (H, W) -> per-orientation response maps (8, H, W) u8.

    response[o] = max over set bits b of (4 - circ_dist(o, b)) — OpenCV's
    graded SIMILARITY_LUT semantics (exact=4, adjacent=3, 2-off=2, 3-off=1,
    opposite=0).
    """
    s = spread_quant.astype(jnp.int32)
    maps = []
    for o in range(8):
        masks = distance_masks(o)
        r = jnp.zeros_like(s)
        # Nearest set bit wins: walk distances outward, keep the first hit.
        for d in range(3, -1, -1):
            r = jnp.where((s & masks[d]) != 0, RESPONSE_BY_DISTANCE[d], r)
        maps.append(r.astype(jnp.uint8))
    return jnp.stack(maps, axis=0)


_PYR5 = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0], jnp.float32) / 16.0
PYR_PRECISION = jax.lax.Precision.HIGHEST


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """cv::pyrDown: 5x5 Gaussian ([1,4,6,4,1]/16 separable) then decimate 2x,
    HALF-UP rounded to the integer grid — the engine's fixed-point pyrDown
    emits u8, and the rounding is load-bearing for bit-exact level-1
    quantization (probed: floor(ours + 0.5) == cv::pyrDown on every pixel;
    unrounded f32 flips ~3% of level-1 orientation bins vs the oracle).

    Works on (H, W) float32; reflect-101 borders.
    """
    x = _reflect_pad2d(img.astype(jnp.float32), 2)
    # Decimation rides the band matrices (odd outputs are never computed;
    # bit-exact vs conv-then-[::2] — same taps, same adds) so no strided
    # slice is ever materialized.  HIGHEST (full float32): the second pass
    # reads sixteenths up to 255, 12 significant bits, which TF32's 10-bit
    # mantissa would round on the GPU.
    out = _conv1d_blocked_dec2(
        _conv1d_blocked_dec2(x, _PYR5, x.ndim - 1, PYR_PRECISION),
        _PYR5, x.ndim - 2, PYR_PRECISION,
    )
    return jnp.floor(out + jnp.float32(0.5))
