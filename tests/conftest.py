"""Test config: run JAX on a virtual 8-device CPU mesh.

The tests run on the host CPU (JAX_PLATFORMS=cpu); sharding correctness is
validated on host-platform virtual devices.  The GPU path is exercised by
chip_smoke.py on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

from linemod_pose_estimation.utils.compile_cache import configure_compile_cache

# Persistent XLA compile cache: the integrative tests compile full-cascade
# programs that cost minutes on CPU; caching makes every rerun after the
# first near-instant.
configure_compile_cache()

import pathlib

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
# The committed reference-scale bank (2652 views) and the cuboid mesh
# fitted to its per-view Rects (tools/fit_box_mesh.py).
BANK_PARAMS = str(DATA / "boxNew_rgbd_params.yml.gz")
BOX_STL = str(DATA / "box_fitted.stl")


# ---------------------------------------------------------------------------
# Disk cache for test renders (the suite's dominant cost on a CPU host: one
# 640x480 STL render takes ~14 s).  Keyed by the render inputs PLUS a hash
# of the rasterizer source, so any renderer change invalidates the cache;
# the arrays returned are bit-identical to a live render.  The cache
# directory is committed (tests/data/render_cache) so cold CI runs skip the
# renders too; the renderer's own parity tests exercise the live path
# through Renderer._batch_fn / models.renderer.render directly.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="session", autouse=True)
def _render_disk_cache():
    import hashlib

    from linemod_pose_estimation.models import renderer as RD

    src = pathlib.Path(RD.__file__).read_bytes()
    ver = hashlib.sha256(src).hexdigest()[:12]
    cdir = pathlib.Path(__file__).parent / "data" / "render_cache"
    cdir.mkdir(parents=True, exist_ok=True)
    orig = RD.Renderer.render

    def render(self, R, T_bank):
        key = hashlib.sha256(
            ver.encode()
            + np.asarray(R, np.float32).tobytes()
            + np.asarray(T_bank, np.float32).tobytes()
            + np.asarray(self.triangles, np.float32).tobytes()
            + repr((self.width, self.height, np.asarray(self.K).tolist(),
                    self.chunk)).encode()
        ).hexdigest()[:24]
        f = cdir / f"{key}.npz"
        if f.exists():
            with np.load(f) as z:
                return RD.RenderOutput(
                    depth_mm=z["depth_mm"], mask=z["mask"], rgb=z["rgb"],
                    rect=z["rect"],
                )
        out = orig(self, R, T_bank)
        np.savez_compressed(
            f, depth_mm=np.asarray(out.depth_mm), mask=np.asarray(out.mask),
            rgb=np.asarray(out.rgb), rect=np.asarray(out.rect),
        )
        return out

    RD.Renderer.render = render
    try:
        yield
    finally:
        RD.Renderer.render = orig
