"""The one backend decision, the compile-cache helper, and chip_smoke.py's
refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from jax import export

from linemod_pose_estimation.ops import backend
from linemod_pose_estimation.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform, walk, engine", [
    ("cpu", "xla", "gather"),
    ("gpu", "triton", "gather"),
])
def test_backend_decision(platform, walk, engine):
    assert backend.platform(platform) == platform
    assert backend.walk_impl(platform) == walk
    assert backend.detector_engine(platform) == engine


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_backend_unknown_platform_raises(platform):
    for decide in (backend.platform, backend.walk_impl,
                   backend.detector_engine):
        with pytest.raises(RuntimeError, match="no implementation chosen"):
            decide(platform)


_IMPLS = {"xla": lambda v: v * 5, "triton": lambda v: v * 3}
_ARG = jax.ShapeDtypeStruct((), jnp.int32)


def _by_walk(x):
    return backend.by_platform(backend.WALK, _IMPLS, x)


def test_by_platform_runs_cpu_branch():
    assert backend.platform() == "cpu"
    assert int(jax.jit(_by_walk)(jnp.int32(1))) == 5


def test_by_platform_lowers_only_the_gpu_branch_for_cuda():
    text = export.export(jax.jit(_by_walk), platforms=["cuda"])(_ARG).mlir_module()
    assert "dense<3>" in text and "dense<5>" not in text


def test_by_platform_refuses_other_platforms():
    with pytest.raises(NotImplementedError, match="platform rocm"):
        export.export(jax.jit(_by_walk), platforms=["rocm"])(_ARG)


def _cache_dir_after(monkeypatch, env_value):
    if env_value is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV, env_value)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        used = compile_cache.configure_compile_cache()
        return used, jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set_sets_nothing(monkeypatch, tmp_path):
    used, configured = _cache_dir_after(monkeypatch, str(tmp_path))
    assert used == str(tmp_path)
    assert configured is None  # JAX reads the variable itself


def test_compile_cache_env_unset_uses_repo_dir(monkeypatch):
    used, configured = _cache_dir_after(monkeypatch, None)
    assert used == configured == os.path.join(REPO, ".jax_cache")


def test_chip_smoke_refuses_cpu_host():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr
