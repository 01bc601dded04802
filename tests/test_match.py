"""Planted-template tests for the matching engine (SURVEY.md section 4:
'render a template into an empty frame -> expect score 100 at the planted
location')."""

import numpy as np
import pytest

from linemod_pose_estimation.models.detector import Detector
from linemod_pose_estimation.models.templates import DetectorParams


def make_object_patch(rng, size=48):
    """A textured disk with strong internal gradients on black background."""
    yy, xx = np.mgrid[0:size, 0:size]
    c = size / 2.0
    disk = (yy - c) ** 2 + (xx - c) ** 2 < (c - 2) ** 2
    tex = ((yy // 6 + xx // 6) % 2) * 180 + 40  # checkerboard
    tex2 = ((yy + 2 * xx) % 13 < 6) * 60
    img = np.zeros((size, size, 3), np.uint8)
    for ch, w in enumerate([1.0, 0.8, 0.6]):
        img[..., ch] = np.where(disk, np.clip(tex * w + tex2, 0, 255), 0).astype(np.uint8)
    return img, (disk * 255).astype(np.uint8)


def plant(frame_shape, patch, pos_yx):
    frame = np.zeros(frame_shape, np.uint8)
    y, x = pos_yx
    frame[y : y + patch.shape[0], x : x + patch.shape[1]] = patch
    return frame


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(7)
    patch, mask = make_object_patch(rng)
    src = plant((120, 160, 3), patch, (36, 56))
    src_mask = plant((120, 160), mask, (36, 56))
    det = Detector(DetectorParams())
    tid = det.add_template(src, src_mask, "obj")
    assert tid == 0
    return det, patch, (36, 56)


def best_position(res):
    """Highest-similarity match; among the equal-score spreading plateau
    (forward spread covers [0, T)), the bottom-right corner is the true
    position — pick max (x + y) among near-max-score matches."""
    top = res.similarity.max()
    sel = res.similarity >= top - 0.5
    idx = np.nonzero(sel)[0]
    return idx[np.argmax(res.x[sel] + res.y[sel])]


def test_self_match_scores_100(trained):
    det, patch, (py, px) = trained
    src = plant((120, 160, 3), patch, (py, px))
    res = det.match(src, threshold=90.0)["obj"]
    assert len(res) >= 1
    best = best_position(res)
    assert res.similarity[best] >= 99.0
    # Match position = template bbox origin in the source image; the
    # cv::linemod walk reports on the T0 grid (+T0/2 offset), so the
    # reference-exact bound is +-T0/2 = 2 px (the genuine engine behaves
    # identically — tests/test_oracle_parity.py pins bit-equality).
    x0, y0, _, _ = det.template_rect0("obj", 0)
    assert abs(int(res.x[best]) - x0) <= 2
    assert abs(int(res.y[best]) - y0) <= 2


def test_shifted_plant_found_within_grid_offset(trained):
    det, patch, (py, px) = trained
    x0, y0, _, _ = det.template_rect0("obj", 0)
    dy, dx = 13, -9  # arbitrary odd shifts
    frame = plant((120, 160, 3), patch, (py + dy, px + dx))
    res = det.match(frame, threshold=90.0)["obj"]
    assert len(res) >= 1
    best = best_position(res)
    assert res.similarity[best] >= 97.0
    # Reference-exact T0-grid reporting: within T0/2 = 2 px of the plant.
    assert abs(int(res.x[best]) - (x0 + dx)) <= 2
    assert abs(int(res.y[best]) - (y0 + dy)) <= 2


def test_empty_frame_no_match(trained):
    det, _, _ = trained
    frame = np.zeros((120, 160, 3), np.uint8)
    res = det.match(frame, threshold=80.0)["obj"]
    assert len(res) == 0


def test_unrelated_texture_no_high_match(trained):
    det, _, _ = trained
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 255, size=(120, 160, 3), dtype=np.uint8)
    res = det.match(frame, threshold=95.0)["obj"]
    # Random noise should not reach near-perfect similarity.
    assert len(res) == 0 or res.similarity.max() < 99.0


def test_bank_yaml_roundtrip(tmp_path, trained):
    det, patch, (py, px) = trained
    p = str(tmp_path / "templates.yml")
    det.write(p)
    det2 = Detector.read(p)
    assert det2.num_templates("obj") == 1
    frame = plant((120, 160, 3), patch, (py, px))
    r1 = det.match(frame, threshold=90.0)["obj"]
    r2 = det2.match(frame, threshold=90.0)["obj"]
    b1, b2 = np.argmax(r1.similarity), np.argmax(r2.similarity)
    assert r1.x[b1] == r2.x[b2] and r1.y[b1] == r2.y[b2]
    np.testing.assert_allclose(r1.similarity[b1], r2.similarity[b2], atol=1e-4)


def test_response_maps_graded_similarity_lut():
    """OpenCV's SIMILARITY_LUT grades by circular bin distance: 4/3/2/1/0
    (linemod.cpp computeResponseMaps) — e.g. a 2-bin-off orientation scores
    2, not 0 (ADVICE.md round-1 finding)."""
    import jax.numpy as jnp
    from linemod_pose_estimation.ops import features as F

    for b in range(8):
        quant = jnp.full((4, 4), 1 << b, jnp.uint8)
        R = F.response_maps(quant)
        for o in range(8):
            d = min(abs(o - b), 8 - abs(o - b))
            assert int(R[o, 0, 0]) == 4 - d, (o, b)

    # Multiple set bits: nearest bit wins.
    quant = jnp.full((2, 2), (1 << 0) | (1 << 3), jnp.uint8)
    R = F.response_maps(quant)
    assert int(R[1, 0, 0]) == 3  # distance 1 to bit0 beats distance 2 to bit3
    assert int(R[5, 0, 0]) == 2  # distance 2 to bit3


@pytest.mark.parametrize("ulps", [0, -2, -1, 1, 2])
def test_similarity_division_is_exact(ulps):
    """correct_quotient recovers IEEE float32 25 * raw / count from a
    quotient up to two ulps off (a GPU's float32 divide), for every
    (raw, count) pair of counts 1..300; similarity() equals the plain
    IEEE division cv::linemod does."""
    import jax.numpy as jnp

    from linemod_pose_estimation.ops import match as M

    cnt = np.concatenate([np.full(4 * c + 1, c) for c in range(1, 301)])
    raw = np.concatenate([np.arange(4 * c + 1) for c in range(1, 301)])
    a = (25 * raw).astype(np.float32)
    b = cnt.astype(np.float32)
    want = a / b
    q0 = want.copy()
    step = np.inf if ulps > 0 else -np.inf
    for _ in range(abs(ulps)):
        q0 = np.nextafter(q0, np.float32(step)).astype(np.float32)
    got = np.asarray(M.correct_quotient(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(q0)))
    np.testing.assert_array_equal(got, want)
    sim = np.asarray(M.similarity(jnp.asarray(raw), jnp.asarray(cnt)))
    np.testing.assert_array_equal(
        sim, np.float32(100.0) * raw.astype(np.float32)
        / (np.float32(4.0) * cnt.astype(np.float32)))
