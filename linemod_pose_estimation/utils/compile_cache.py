"""Where JAX keeps its persistent compilation cache: the one helper every
entry point (bench.py, chip_smoke.py, the CLI, tools/, the tests) calls.

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; no code here
  sets a directory.
- Otherwise the cache goes to ``<repo>/.jax_cache`` (listed in .gitignore),
  inside the checkout and at a fixed path, so reruns hit it.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def configure_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compile cache at the environment's directory
    or at DEFAULT_DIR; returns the directory in use.  Programs compiling
    in under `min_compile_secs` are not cached."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    env_dir = os.environ.get(ENV)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
