"""CLI entry points: python -m linemod_pose_estimation train|detect|serve
(the reference's 4 executables' argv contracts, SURVEY.md section 5)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import BOX_STL

STL = BOX_STL
ENV_ARGS = ["-m", "linemod_pose_estimation"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, input_text=None, timeout=600):
    # CPU-only subprocesses: no second process ever opens an accelerator.
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, *ENV_ARGS, *args],
        capture_output=True, text=True, timeout=timeout, input=input_text,
        cwd=REPO, env=env,
    )


@pytest.fixture(scope="module")
def trained_bank(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    tpl, prm = str(d / "templates.yml"), str(d / "params.yml")
    r = run_cli([
        "train", STL, "--templates-out", tpl, "--params-out", prm,
        "--n-points", "8", "--angle-step", "120", "--radius-min", "0.6",
        "--radius-max", "0.6", "--radius-step", "0.1",
        "--width", "160", "--height", "120", "--fx", "133.9", "--fy", "134.3",
        "--max-views", "6", "--class-id", "boxNew",
    ])
    assert r.returncode == 0, r.stderr[-2000:]
    info = json.loads(r.stdout.strip().splitlines()[-1])
    assert info["templates"] >= 1
    return d, tpl, prm


def _make_replay(d, tpl, prm):
    """Render one training view into a replay frame fixture."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from linemod_pose_estimation.api.nodes import save_replay_frame
    from linemod_pose_estimation.models.renderer import Renderer
    from linemod_pose_estimation.models.templates import TemplateBank
    from linemod_pose_estimation.utils import pointcloud as pcu

    meta, glob = TemplateBank.read_params_yaml(prm)
    r = Renderer(STL, glob.width, glob.height, glob.focal_length_x, glob.focal_length_y)
    out = r.render(meta.R[0], meta.T[0])
    cloud = np.asarray(pcu.depth_to_cloud(np.asarray(out.depth_mm) / 1000.0, r.K))
    path = str(d / "frame0.npz")
    save_replay_frame(path, np.asarray(out.rgb), cloud)
    return path


@pytest.mark.slow
def test_cli_detect_and_serve(trained_bank):
    d, tpl, prm = trained_bank
    frame = _make_replay(d, tpl, prm)

    fast = ["--canonicalize", "none", "--icp-max-iter", "40",
            "--max-clusters", "2", "--model-cap", "512", "--scene-cap", "512"]
    r = run_cli([
        "detect", tpl, prm, STL, frame, "--count", "1",
        "--threshold", "85", *fast,
    ])
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["frame"] == 0
    assert len(rec["detections"]) >= 1
    assert rec["detections"][0]["score"] >= 85.0

    r = run_cli(
        [
            "serve", frame,
            "--object", f"0:{tpl}:{prm}:{STL}:85",
            *fast,
        ],
        input_text="0\n7\nquit\n",
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(l) for l in r.stdout.strip().splitlines()]
    assert lines[0] == {"serving": [0]}
    hit = lines[1]
    assert hit["object_id"] == 0
    assert any(abs(v) > 1e-9 for v in hit["translation"])  # found -> non-identity
    miss = lines[2]  # unknown object -> identity transform (service.cpp:1832-1846)
    assert miss["translation"] == [0.0, 0.0, 0.0]
    assert miss["rotation_xyzw"] == [0.0, 0.0, 0.0, 1.0]
