import numpy as np
import pytest

from conftest import BANK_PARAMS
from linemod_pose_estimation.models.templates import _maybe_ungz
from linemod_pose_estimation.utils import opencv_yaml as oy


def test_parse_shipped_bank():
    """The committed 2652-view params bank parses through the PyYAML
    reader (cv::FileStorage layout)."""
    doc = oy.load(_maybe_ungz(BANK_PARAMS))
    assert "Template 0" in doc and "Template 2651" in doc
    t0 = doc["Template 0"]
    assert t0["ID"] == 0
    assert t0["R"].shape == (3, 3) and t0["R"].dtype == np.float64
    assert t0["T"].shape == (3, 1)
    assert t0["K"].shape == (3, 3) and t0["K"].dtype == np.float32
    assert t0["Rect"] == [253, 195, 147, 105]
    np.testing.assert_allclose(t0["Ori_dist"], 0.5)
    assert doc["renderer_n_points"] == 150
    assert doc["renderer_width"] == 640
    np.testing.assert_allclose(doc["renderer_focal_length_x"], 535.566011)


def test_roundtrip_through_own_parser(tmp_path):
    doc = {
        "Template 0": {
            "ID": 0,
            "R": oy.CvMatrix(np.eye(3)),
            "T": oy.CvMatrix(np.array([[0.1], [0.2], [0.3]])),
            "K": oy.CvMatrix(np.array([[535.5, 0, 320], [0, 537.1, 240], [0, 0, 1]], np.float32)),
            "D": 0.047,
            "Ori_dist": 0.5,
            "Rect": [1, 2, 3, 4],
        },
        "renderer_n_points": 150,
        "renderer_radius_min": 0.5,
    }
    p = tmp_path / "bank.yml"
    oy.dump(doc, str(p))
    d2 = oy.load(str(p))
    np.testing.assert_allclose(d2["Template 0"]["R"], np.eye(3))
    np.testing.assert_allclose(d2["Template 0"]["K"], doc["Template 0"]["K"].array, rtol=1e-6)
    assert d2["Template 0"]["Rect"] == [1, 2, 3, 4]
    assert d2["renderer_n_points"] == 150


def test_emitted_yaml_readable_by_opencv(tmp_path):
    """Golden cross-check: cv2.FileStorage (the reference's serializer) must
    read our emitted bank identically."""
    cv2 = pytest.importorskip("cv2")
    doc = {
        "Template 0": {
            "ID": 7,
            "R": oy.CvMatrix(np.arange(9, dtype=np.float64).reshape(3, 3) / 7.0),
            "Rect": [276, 205, 89, 67],
        },
        "renderer_radius_step": 0.1,
        "renderer_far": 1000.0,
    }
    p = str(tmp_path / "emit.yml")
    oy.dump(doc, p)
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
    node = fs.getNode("Template 0")
    assert int(node.getNode("ID").real()) == 7
    np.testing.assert_allclose(node.getNode("R").mat(), doc["Template 0"]["R"].array)
    rect = [int(node.getNode("Rect").at(i).real()) for i in range(4)]
    assert rect == [276, 205, 89, 67]
    np.testing.assert_allclose(fs.getNode("renderer_radius_step").real(), 0.1)
    np.testing.assert_allclose(fs.getNode("renderer_far").real(), 1000.0)
    fs.release()


def test_opencv_written_yaml_readable_by_us(tmp_path):
    cv2 = pytest.importorskip("cv2")
    p = str(tmp_path / "cvout.yml")
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_WRITE)
    fs.write("mat", np.linspace(0, 1, 12).reshape(3, 4))
    fs.write("count", 42)
    fs.write("name", "obj")
    fs.release()
    doc = oy.load(p)
    np.testing.assert_allclose(doc["mat"], np.linspace(0, 1, 12).reshape(3, 4))
    assert doc["count"] == 42
    assert doc["name"] == "obj"


GOLDEN_LINEMOD = "tests/data/opencv_linemod_golden.yml"


def test_read_genuine_opencv_linemod_bank():
    """Cross-read a cv::linemod-format templates.yml (hand-built to OpenCV's
    Detector::write/writeClass/Template::write/Feature::write layout,
    rgbdDetector.cpp:1668-1692): template entries carry no modality name
    (position encodes it), feature rows are [x, y, label]."""
    from linemod_pose_estimation.models.templates import TemplateBank

    bank = TemplateBank.read_templates_yaml(GOLDEN_LINEMOD, f_cap=8)
    assert bank.class_id == "golden_obj"
    assert bank.params.t_pyramid == (5, 8)
    assert bank.params.use_color_gradient and bank.params.use_depth_normal
    assert bank.num_templates == 2
    t0 = bank.templates[0]
    # ColorGradient level 0 of template 0: [x,y,l] rows (11,3,4),(25,7,2),
    # (39,29,7) -> internal (y,x,ori).
    np.testing.assert_array_equal(
        t0.grad[0], np.array([[3, 11, 4], [7, 25, 2], [29, 39, 7]], np.int32)
    )
    np.testing.assert_array_equal(t0.norm[0], np.array([[9, 5, 1], [20, 30, 6]], np.int32))
    np.testing.assert_array_equal(t0.grad[1], np.array([[2, 6, 3], [14, 19, 0]], np.int32))
    np.testing.assert_array_equal(t0.norm[1], np.array([[4, 2, 5]], np.int32))
    assert t0.size[0] == (30, 40) and t0.size[1] == (15, 20)
    t1 = bank.templates[1]
    np.testing.assert_array_equal(t1.grad[0], np.array([[2, 1, 0], [11, 15, 3]], np.int32))
    np.testing.assert_array_equal(t1.norm[1], np.array([[5, 7, 4]], np.int32))


def test_native_matches_pyyaml_on_opencv_bank():
    """Native C++ parser and PyYAML agree on a genuine OpenCV-layout bank."""
    from linemod_pose_estimation.utils import native

    if not native.available():
        pytest.skip("native loader not built")
    nat = native.load_templates_native(GOLDEN_LINEMOD)
    assert nat is not None
    entries, features, header, mparams = nat
    assert len(entries) == 8  # 2 pyramids x 2 levels x 2 modalities
    # entry: pid, w, h, level, modality, nf
    np.testing.assert_array_equal(entries[0], [0, 40, 30, 0, 0, 3])
    np.testing.assert_array_equal(entries[1], [0, 40, 30, 0, 1, 2])
    np.testing.assert_array_equal(entries[2], [0, 20, 15, 1, 0, 2])
    np.testing.assert_array_equal(entries[3], [0, 20, 15, 1, 1, 1])
    # raw file order [x, y, label]
    np.testing.assert_array_equal(features[0], [11, 3, 4])
    np.testing.assert_array_equal(features[3], [5, 9, 1])
    # header[1] is a modality bitmask: bit0 ColorGradient | bit1 DepthNormal.
    assert list(header) == [2, 3, 5, 8]


def test_written_bank_feature_order_is_opencv(tmp_path):
    """Our writer emits Feature rows as [x, y, label] block sequences that
    cv2.FileStorage reads back verbatim."""
    cv2 = pytest.importorskip("cv2")
    from linemod_pose_estimation.models.templates import (
        DetectorParams, TemplateBank, TemplateFeatures,
    )

    t = TemplateFeatures(
        grad=[np.array([[3, 11, 4], [7, 25, 2]], np.int32),
              np.array([[2, 6, 3]], np.int32)],
        norm=[],
        size=[(30, 40), (15, 20)],
        rect0=(0, 0, 40, 30),
    )
    bank = TemplateBank("obj", DetectorParams(), [t], f_cap=8)
    p = str(tmp_path / "templates.yml")
    bank.write_templates_yaml(p)
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
    cls = fs.getNode("classes").at(0)
    assert cls.getNode("class_id").string() == "obj"
    mods = cls.getNode("modalities")
    assert mods.at(0).string() == "ColorGradient"
    e0 = cls.getNode("template_pyramids").at(0).getNode("templates").at(0)
    assert int(e0.getNode("width").real()) == 40
    f0 = e0.getNode("features").at(0)
    # internal (y=3, x=11, ori=4) -> serialized [x, y, label] = [11, 3, 4]
    assert [int(f0.at(i).real()) for i in range(3)] == [11, 3, 4]
    fs.release()
    # And it round-trips through our own readers.
    b2 = TemplateBank.read_templates_yaml(p, f_cap=8)
    np.testing.assert_array_equal(b2.templates[0].grad[0], t.grad[0])
    np.testing.assert_array_equal(b2.templates[0].grad[1], t.grad[1])


def test_render_dump_roundtrip(tmp_path, rng):
    """writeLinemodRender analog (renderer.cpp:125-146): Template i ->
    {ID, Depth u16, Mask u8, Rect} round-trips, and cv2.FileStorage reads
    the same matrices."""
    from linemod_pose_estimation.models.templates import TemplateBank

    depths = [rng.integers(0, 1200, size=(24, 32), dtype=np.uint16) for _ in range(2)]
    masks = [(rng.random((24, 32)) < 0.5).astype(np.uint8) * 255 for _ in range(2)]
    rects = [(3, 4, 10, 12), (1, 2, 20, 8)]
    p = str(tmp_path / "render.yml")
    TemplateBank.write_render_dump(p, depths, masks, rects)
    back = TemplateBank.read_render_dump(p)
    assert len(back) == 2
    for i, (d, m, rc) in enumerate(back):
        np.testing.assert_array_equal(d, depths[i])
        np.testing.assert_array_equal(m, masks[i])
        assert rc == rects[i]

    cv2 = pytest.importorskip("cv2")
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
    node = fs.getNode("Template 1")
    np.testing.assert_array_equal(node.getNode("Depth").mat(), depths[1])
    assert int(node.getNode("ID").real()) == 1
    fs.release()


def test_depth_only_bank_roundtrip(tmp_path):
    """Depth-only banks (use_color_gradient=False) round-trip through both
    readers with correct modality labeling (round-2 review finding: the
    native parser used to assume ColorGradient-first and mislabeled them)."""
    from linemod_pose_estimation.models.templates import (
        DetectorParams, TemplateBank, TemplateFeatures,
    )

    params = DetectorParams(use_color_gradient=False, use_depth_normal=True)
    t = TemplateFeatures(
        grad=[],
        norm=[np.array([[3, 11, 4], [7, 25, 2]], np.int32),
              np.array([[2, 6, 3]], np.int32)],
        size=[(30, 40), (15, 20)],
        rect0=(0, 0, 40, 30),
    )
    bank = TemplateBank("depth_obj", params, [t], f_cap=8)
    p = str(tmp_path / "depth_only.yml")
    bank.write_templates_yaml(p)

    b2 = TemplateBank.read_templates_yaml(p, f_cap=8)
    assert not b2.params.use_color_gradient
    assert b2.params.use_depth_normal
    assert b2.templates[0].grad == []
    np.testing.assert_array_equal(b2.templates[0].norm[0], t.norm[0])
    np.testing.assert_array_equal(b2.templates[0].norm[1], t.norm[1])
