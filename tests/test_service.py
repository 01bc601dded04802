"""PoseService request/response semantics + robot transform chain."""

import numpy as np
import pytest

from linemod_pose_estimation.api import transforms as TR
from linemod_pose_estimation.api.service import Frame, PoseService, condition_frame


def test_identity_on_unknown_object():
    svc = PoseService(frame_source=lambda: Frame(np.zeros((10, 10, 3), np.uint8),
                                                 np.zeros((10, 10, 3), np.float32)))
    t = svc.linemod_object_pose(42)
    assert t.translation == (0.0, 0.0, 0.0)
    assert t.rotation == (0.0, 0.0, 0.0, 1.0)


def test_hand_eye_chain_matches_reference_constant():
    he = TR.tool0_to_depth()
    np.testing.assert_allclose(he[:3, 3], [0.0672827, -0.0546864, 0.0466534])
    # Rotation ~ 90 deg about a near-z axis (qw ~ qz ~ 0.707).
    R = he[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    tr = np.trace(R)
    ang = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
    assert 89.0 < ang < 92.0


def test_base_to_object_chain_composition(rng):
    # chain = base_tool0 @ hand_eye @ depth_obj
    t_obj = np.eye(4)
    t_obj[:3, 3] = [0.1, 0.2, 0.5]
    base_tool0 = np.eye(4)
    base_tool0[:3, 3] = [1.0, 2.0, 3.0]
    out = TR.base_to_object(base_tool0, t_obj)
    expect = base_tool0 @ TR.tool0_to_depth() @ t_obj
    np.testing.assert_allclose(out, expect)


def test_affine_to_transform_roundtrip(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    T = TR.make_affine(0.3, -0.1, 0.8, *q)
    t = TR.affine_to_transform(T)
    T2 = TR.make_affine(*t.translation, t.rotation[3], *t.rotation[:3])
    np.testing.assert_allclose(T2, T, atol=1e-6)


def test_condition_frame_mono_and_crop():
    mono = np.full((480, 752), 128, np.uint8)
    mono[:, 56] = 255  # first kept column after crop
    f = condition_frame(Frame(mono, np.zeros((480, 752, 3), np.float32)),
                        bias_x=56, blur=False)
    assert f.rgb.shape == (480, 640, 3)
    assert f.rgb[0, 0, 0] == 255  # crop starts at bias_x
    assert f.rgb[0, 1, 0] == 128
