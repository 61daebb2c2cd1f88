"""The reduction of a trace: busy time as the union of device intervals,
idle gaps named by the benchmark's calls, launches by kernel name."""

import pytest

from slambench.harness import trace, window


def test_busy_is_the_union_of_intervals():
    ops = [(0, 10, "a"), (5, 15, "b"), (20, 30, "a"), (21, 22, "c")]
    assert trace.merged(ops) == [(0, 15), (20, 30)]
    assert trace.busy_ns(ops) == 25


def test_kernels_by_name_and_fragment():
    ops = [(0, 1000, "fast_nms_pyramid_kernel(Pyramid)"), (2000, 2500, "x"),
           (3000, 4000, "fast_nms_pyramid_kernel(Pyramid)")]
    kernels = trace.by_name(ops)
    assert trace.kernel(kernels, "fast_nms_pyramid_kernel") == (2, pytest.approx(2e-6))
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def test_idle_gaps_are_named_by_the_open_call():
    us = 1000
    calls = [(0, 100 * us, False), (100 * us, 200 * us, False),
             (250 * us, 400 * us, True)]
    w = window.Window(0, 400 * us, 0, 3, [], [], calls)
    ops = [(300 * us, 395 * us, "k"), (395 * us + 500, 398 * us, "k")]
    gaps = dict(trace.idle_gaps_by_call(ops, w))
    assert gaps[trace.CALL_NAMES[False]] == pytest.approx(200e-6)
    assert gaps[trace.BETWEEN_CALLS] == pytest.approx(50e-6)
    assert gaps[trace.CALL_NAMES[True]] == pytest.approx(50e-6)
    assert gaps[trace.SHORT_GAP_NAME] == pytest.approx(2.5e-6)


class _Entry:
    """Returns a chunk of `n` rows every `n`-th call, after a first call
    that returns nothing (the bootstrap)."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def feed(self, first, second):
        self.calls += 1
        if self.calls == 1 or (self.calls - 1) % self.n:
            return None
        import numpy as np
        return {"tracked": np.ones(self.n, bool), "is_kf": np.zeros(self.n, bool)}


class _Lap:
    frames = 10

    def frame(self, i):
        return i, i


def test_the_window_stops_on_a_chunk_after_its_time():
    ticks = iter(range(10_000))
    w = window.drive(_Entry(4), _Lap(), 0, seconds=30, clock=lambda: next(ticks))
    assert w.handed == 1 + 4 * len(w.chunks)
    assert sum(c[2] for c in w.chunks) == w.handed - 1
    assert w.chunks[-1][1] - w.t_start >= 30
    assert w.chunks[-2][1] - w.t_start < 30
    assert len(w.calls) == w.handed


def test_the_warm_lap_ends_on_a_chunk():
    w = window.drive(_Entry(8), _Lap(), 0, frames=1 + 8 * 3)
    assert w.handed == 25 and len(w.chunks) == 3
