"""Multi-camera / multi-host frame ingest: the DCN story.

The reference's inter-process fabric is ROS over TCPROS — one camera daemon
feeding one detector node (SURVEY.md section 2.3 / section 5 "distributed
communication backend").  The device-native equivalent splits transport
by physical link:

- host -> its local chips: `jax.device_put` of the host's frame batch
  (PCIe), sharded over the mesh's "data" axis;
- host <-> host (multi-host clusters): each process contributes its LOCAL
  cameras' frames as its process-local shard of one GLOBAL batch array via
  `jax.make_array_from_process_local_data` — XLA moves shards over DCN only
  if a later computation requires it (with the detect step's pure-DP layout
  it never does: each host's frames stay on its own chips, and only the
  O(top_k) match records cross hosts in the collectives);
- device <-> device: collectives inside the detect step
  (parallel/sharded_match.py).

`FrameBatcher` is the host-side seam: it polls any number of camera
callables (Ensenso grab services, replay fixtures — E4) round-robin into
fixed-size batches, mirroring the reference's grab_registered_image RPC
loop but N cameras wide.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class FrameBatcher:
    """Round-robin N camera sources into (B, H, W, 3) u8 + (B, H, W, 3) f32
    cloud batches (B = frames per step, typically a multiple of the mesh's
    "data" size)."""

    def __init__(self, sources: Sequence[Callable[[], object]], batch: int):
        if not sources:
            raise ValueError("need at least one frame source")
        self.sources = list(sources)
        self.batch = batch
        self._i = 0

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        rgbs, clouds = [], []
        for _ in range(self.batch):
            f = self.sources[self._i % len(self.sources)]()
            self._i += 1
            rgbs.append(np.asarray(f.rgb))
            clouds.append(np.asarray(f.cloud))
        return np.stack(rgbs), np.stack(clouds)

    def poll_batch(self, now: float | None = None):
        """Take whatever frames the (paced) sources have ready — up to
        `batch` — WITHOUT waiting: the streaming-load seam where camera
        cadence, not the matcher, sets the arrival rate (the carmine node
        processes one callback at a time and drops the backlog —
        linemod_carmine_detect.cpp:296-306; here late
        frames batch up instead of dropping).

        Sources must expose poll(now) -> (frame, t_grab) | None (see
        PacedSource).  Returns (rgbs (B,...), clouds (B,...), stamps (B,),
        n_filled); slots past n_filled repeat the last real frame so the
        fixed-shape jitted step never recompiles — callers mask by
        n_filled.  Returns None when no source had a frame ready."""
        import time as _time

        if now is None:
            now = _time.perf_counter()
        rgbs, clouds, stamps = [], [], []
        for k in range(len(self.sources)):
            if len(rgbs) >= self.batch:
                break
            src = self.sources[(self._i + k) % len(self.sources)]
            got = src.poll(now)
            while got is not None:
                f, t_grab = got
                rgbs.append(np.asarray(f.rgb))
                clouds.append(np.asarray(f.cloud))
                stamps.append(t_grab)
                if len(rgbs) >= self.batch:
                    break
                got = src.poll(now)
        self._i += 1  # rotate polling priority for fairness
        n = len(rgbs)
        if n == 0:
            return None
        while len(rgbs) < self.batch:  # pad: repeat the last real frame
            rgbs.append(rgbs[n - 1])
            clouds.append(clouds[n - 1])
            stamps.append(stamps[n - 1])
        return np.stack(rgbs), np.stack(clouds), np.asarray(stamps), n


class PacedSource:
    """A camera source with a fixed frame cadence (the Carmine/Ensenso
    drivers deliver at sensor rate regardless of the consumer): poll(now)
    returns (frame, t_grab) for each elapsed frame period, else None.  A
    slow consumer sees a backlog (up to `max_backlog` frames, then drops
    oldest — sensor ring-buffer semantics), which is what lets the
    streaming bench measure latency UNDER LOAD rather than in lockstep."""

    def __init__(self, fn: Callable[[], object], fps: float,
                 start: float | None = None, max_backlog: int = 64):
        self.fn = fn
        self.period = 1.0 / float(fps)
        # None = anchor the cadence to the FIRST poll's clock.  A fixed
        # default (0.0) against a perf_counter-based `now` (~uptime) would
        # fabricate millions of "elapsed" frames on the first poll and
        # corrupt the dropped/backlog statistics.
        self._next_due = start
        self.max_backlog = max_backlog
        self.dropped = 0

    def poll(self, now: float):
        if self._next_due is None:
            self._next_due = now
        if now < self._next_due:
            return None
        behind = int((now - self._next_due) / self.period)
        if behind >= self.max_backlog:
            self.dropped += behind - self.max_backlog + 1
            self._next_due += (behind - self.max_backlog + 1) * self.period
        t_grab = self._next_due
        self._next_due += self.period
        return self.fn(), t_grab


def put_global_batch(
    mesh: Mesh,
    local_rgbs: np.ndarray,
    local_depths: np.ndarray | None = None,
):
    """Assemble this process's frames into the GLOBAL data-parallel batch.

    Single-host: equivalent to `jax.device_put` with a P("data") sharding.
    Multi-host: every process calls this with its local cameras' frames; the
    returned global arrays have batch size sum(local batches) and shard over
    the global "data" axis without any host gathering — the DCN ingest seam.
    """
    sharding = NamedSharding(mesh, P("data"))
    rgbs = jax.make_array_from_process_local_data(sharding, np.asarray(local_rgbs))
    if local_depths is None:
        return rgbs, None
    depths = jax.make_array_from_process_local_data(
        sharding, np.asarray(local_depths)
    )
    return rgbs, depths
