"""Streaming serving seams: PipelinedRunner (N batches in flight),
PacedSource (sensor-cadence replay), FrameBatcher.poll_batch (take-what's-
ready batching under load) — the pieces of tools/bench_streaming.py."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from linemod_pose_estimation.models.serving import PipelinedRunner
from linemod_pose_estimation.parallel.ingest import FrameBatcher, PacedSource


def test_pipelined_runner_order_and_equality():
    @jax.jit
    def f(x):
        return x * 2 + 1

    run = PipelinedRunner(f, depth=2)
    outs = []
    for i in range(7):
        got = run.submit(jnp.float32(i))
        if got is not None:
            outs.append(float(got))
        assert len(run) <= 2
    outs.extend(float(g) for g in run.drain())
    assert outs == [float(i) * 2 + 1 for i in range(7)]
    assert len(run) == 0


def test_pipelined_runner_depth_one_is_synchronous():
    run = PipelinedRunner(lambda x: x + 1, depth=1)
    assert run.submit(1) is None
    assert run.submit(10) == 2
    assert run.drain() == [11]


def test_paced_source_cadence_and_backlog():
    calls = {"n": 0}

    def grab():
        calls["n"] += 1
        return calls["n"]

    src = PacedSource(grab, fps=10.0, start=0.0, max_backlog=4)
    assert src.poll(-0.01) is None
    f, t = src.poll(0.0)
    assert (f, t) == (1, 0.0)
    assert src.poll(0.05) is None  # next frame due at 0.1
    f, t = src.poll(0.1)
    assert t == 0.1 and f == 2
    # Far behind: backlog caps at 4, the rest counted as dropped.
    src2 = PacedSource(grab, fps=10.0, start=0.0, max_backlog=4)
    got = []
    while True:
        g = src2.poll(1.0)  # 11 frames elapsed (0.0 .. 1.0)
        if g is None:
            break
        got.append(g)
    assert len(got) == 4
    assert src2.dropped == 7
    # Grab stamps stay on the cadence grid.
    assert all(abs((t * 10) - round(t * 10)) < 1e-9 for _, t in got)


def _frame(i):
    return SimpleNamespace(rgb=np.full((4, 6, 3), i, np.uint8),
                           cloud=np.full((4, 6), float(i), np.float32))


def test_poll_batch_fill_and_padding():
    srcs = [PacedSource(lambda i=i: _frame(i), fps=10.0, start=0.0)
            for i in range(3)]
    fb = FrameBatcher(srcs, batch=8)
    assert fb.poll_batch(now=-1.0) is None
    rgbs, clouds, stamps, n = fb.poll_batch(now=0.0)
    assert n == 3 and rgbs.shape == (8, 4, 6, 3) and stamps.shape == (8,)
    # Padding repeats the last real frame.
    assert (rgbs[3:] == rgbs[2]).all()
    # Nothing new until the next period.
    assert fb.poll_batch(now=0.05) is None
    # After a long gap each source has a backlog; batch caps at 8.
    out = fb.poll_batch(now=1.0)
    assert out[3] == 8


def test_poll_batch_under_slow_consumer_accumulates():
    srcs = [PacedSource(lambda i=i: _frame(i), fps=100.0, start=0.0)
            for i in range(2)]
    fb = FrameBatcher(srcs, batch=16)
    r1 = fb.poll_batch(now=0.0)
    assert r1[3] == 2
    r2 = fb.poll_batch(now=0.05)  # 5 more periods elapsed per camera
    assert r2[3] == 10


def test_pipelined_runner_submit_failure_loses_nothing():
    """A raising fn must not swallow an already-collected result or desync
    result/metadata pairing: dispatch happens before the blocking collect,
    so a failed submit leaves the queue exactly as it was."""
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        if x == "boom":
            raise RuntimeError("transient")
        return x + 1

    run = PipelinedRunner(f, depth=2)
    assert run.submit(0) is None
    assert run.submit(10) is None
    try:
        run.submit("boom")
    except RuntimeError:
        pass
    else:
        raise AssertionError("expected the fn's error to propagate")
    # Both in-flight results survive the failed submit, in order.
    assert len(run) == 2
    assert run.submit(20) == 1
    assert run.drain() == [11, 21]


def test_paced_source_lazy_start_anchor():
    """Default start=None anchors the cadence to the FIRST poll's clock
    (perf_counter-scale `now` must not fabricate elapsed frames/drops)."""
    src = PacedSource(lambda: "f", fps=10.0, max_backlog=4)
    uptime = 98765.4321  # perf_counter-style big clock
    f, t = src.poll(uptime)
    assert (f, t) == ("f", uptime)
    assert src.dropped == 0
    assert src.poll(uptime + 0.05) is None
    f2, t2 = src.poll(uptime + 0.1)
    assert f2 == "f" and abs(t2 - (uptime + 0.1)) < 1e-9
    assert src.dropped == 0
