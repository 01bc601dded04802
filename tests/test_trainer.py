"""Trainer end-to-end: STL -> bank -> YAMLs -> reload -> detect."""

import numpy as np
import pytest

from linemod_pose_estimation.models.detector import Detector
from linemod_pose_estimation.models.templates import DetectorParams, TemplateBank
from linemod_pose_estimation.models.trainer import TrainerConfig, train_and_write
from linemod_pose_estimation.utils.viewsphere import ViewSphereParams, generate_views

from conftest import BOX_STL as STL


def small_config():
    return TrainerConfig(
        view_sphere=ViewSphereParams(
            n_points=4, angle_step=180, radius_min=0.5, radius_max=0.5, radius_step=0.1
        ),
        width=160,
        height=120,
        focal_length_x=535.566011 / 4,
        focal_length_y=537.168115 / 4,
        render_batch=4,
    )


def test_view_sphere_grid_size():
    vs = ViewSphereParams(n_points=10, angle_step=90, radius_min=0.5, radius_max=0.7,
                          radius_step=0.1)
    views = generate_views(vs)
    assert len(views) == 10 * 4 * 3  # points x angles x radii
    for v in views[:5]:
        # T = negative camera position; |T| = radius; R row2 = normalize(T).
        np.testing.assert_allclose(np.linalg.norm(v.T), 0.5, atol=1e-6)
        np.testing.assert_allclose(v.R[2], v.T / np.linalg.norm(v.T), atol=1e-6)
        np.testing.assert_allclose(v.R @ v.R.T, np.eye(3), atol=1e-6)


@pytest.mark.slow
@pytest.mark.slow
def test_trainer_produces_bank_and_yaml(tmp_path):
    tyml = str(tmp_path / "templates.yml")
    pyml = str(tmp_path / "params.yml")
    det, bank = train_and_write(STL, tyml, pyml, config=small_config())
    n = bank.num_templates
    assert n >= 4  # 8 views, most should have enough features

    # Params yaml round-trips through our reader (reference schema).
    meta, glob = TemplateBank.read_params_yaml(pyml)
    assert meta.R.shape == (n, 3, 3)
    assert glob.width == 160 and glob.radius_min == 0.5
    # D ~ Ori_dist - center depth: smaller than Ori_dist, positive-ish.
    assert np.all(meta.D < meta.Ori_dist)

    # Templates yaml reloads into a working detector.
    det2 = Detector.read(tyml)
    assert det2.num_templates("obj") == n

    # A trained view re-renders and matches itself.
    from linemod_pose_estimation.models.renderer import Renderer

    r = Renderer(STL, 160, 120, 535.566011 / 4, 537.168115 / 4)
    out = r.render(meta.R[0], meta.T[0])
    res = det2.match(np.asarray(out.rgb), threshold=88.0)["obj"]
    assert len(res) >= 1
    assert res.similarity.max() >= 95.0
    assert 0 in set(res.template_id.tolist())
