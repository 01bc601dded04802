"""Device-mesh construction for multi-chip LINEMOD.

Axes (SURVEY.md section 2.3's mapping of the reference's absent parallelism
onto a device mesh):

- "data": batch frames / cameras across chips (replaces one-ROS-callback-
  at-a-time serialization).
- "bank": shard the template bank (the reference's scale axis is
  templates x window positions); each device scores its template shard
  against the full frame, results merge with collectives.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int = 1, bank: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if bank is None:
        bank = n // data
    if data * bank != n:
        raise ValueError(f"mesh {data}x{bank} != {n} devices")
    arr = np.asarray(devices).reshape(data, bank)
    return Mesh(arr, ("data", "bank"))


def bank_sharding(mesh: Mesh) -> NamedSharding:
    """Template-bank arrays: leading template axis sharded over 'bank'."""
    return NamedSharding(mesh, P("bank"))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Frame batches: leading batch axis sharded over 'data'."""
    return NamedSharding(mesh, P("data"))
