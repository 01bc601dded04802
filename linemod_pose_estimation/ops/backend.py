"""Which implementation runs on which device: the one place that asks.

Every choice between two implementations of the same result is answered
here from the platform — and nothing else (no environment variable, no
flag).  Callers may still pass an explicit choice; the defaults come from
this module.  A platform this module does not know raises: no path is
picked for a device nobody has measured.

- ``"cpu"``: plain XLA everywhere (the test platform).
- ``"gpu"``: plain XLA, plus the Pallas-Triton refinement walk
  (ops.walk_triton), kept because the pooled match measured faster end to
  end with it on the H100 (PERF.md).

Choices made inside a jitted function (the walk) go through
``by_platform``, so they follow the platform the computation is lowered
for — a jit committed to the CPU on a GPU host takes the CPU branch.
Choices made on the host (Detector's engine) use ``platform()``.
"""

from __future__ import annotations

from typing import Callable

import jax

SUPPORTED = ("cpu", "gpu")
# jax.lax.platform_dependent's name for each supported platform.
_LOWERING = {"cpu": "cpu", "gpu": "cuda"}
# The level-0 refinement walk per platform (ops.match.walk_scores_xla or
# ops.walk_triton.walk_scores_triton).
WALK = {"cpu": "xla", "gpu": "triton"}


def platform(name: str | None = None) -> str:
    """`name`, or JAX's default backend; raises for a platform no path
    was chosen for."""
    name = jax.default_backend() if name is None else name
    if name not in SUPPORTED:
        raise RuntimeError(
            f"no implementation chosen for platform {name!r}; supported: "
            f"{', '.join(SUPPORTED)}")
    return name


def walk_impl(name: str | None = None) -> str:
    """"xla" (the scan) or "triton" (the Pallas kernel) for the walk."""
    return WALK[platform(name)]


def by_platform(table: dict[str, str], impls: dict[str, Callable], *args):
    """Call ``impls[table[p]](*args)`` for the platform ``p`` the
    enclosing computation is lowered for (jax.lax.platform_dependent:
    only that branch is lowered).  Lowering for any platform outside
    SUPPORTED fails."""
    branches = {_LOWERING[p]: impls[table[p]] for p in SUPPORTED}
    return jax.lax.platform_dependent(*args, **branches)


def detector_engine(name: str | None = None) -> str:
    """Detector's coarse scoring: "gather" (the linearized-plane scan,
    ops.match.coarse_scores) or "conv" (the one-hot GEMM,
    ops.match.coarse_scores_gemm)."""
    platform(name)
    return "gather"
