"""Reduction of a `torch.profiler` pass to what the per-layer metrics read.

One device-only pass (CUDA activities alone) over frames of the stream
after the measured window: the device operations (kernels, copies, fills)
with their names and times, the union of their intervals (`busy_s`), the
pass's wall time on the host's clock (`window_s`), and the device's idle
gaps named by the benchmark's own call that was open at each (the pass
times its calls with `time.time_ns`, the clock of the trace's timestamps).

The tracer lengthens every graph launch on the host (CUPTI records each
node), so the pass's wall time, and the idle share it gives, are the
traced run's; the device's own times are not changed.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable

SHORT_GAP_NS = 10_000
SHORT_GAP_NAME = "gaps under 10 us (between queued device operations)"


def _is_device(e) -> bool:
    return (str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation() and e.duration_ns() > 0)


def device_ops(events) -> list[tuple[int, int, str]]:
    """(start_ns, end_ns, name) of every operation that ran on the device."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in events if _is_device(e))


def merged(intervals) -> list[tuple[int, int]]:
    """Union of (start, end, ...) intervals as disjoint sorted spans."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals) -> int:
    return sum(e - s for s, e in merged(intervals))


def by_name(ops) -> dict:
    """{name: [count, seconds]} over device operations."""
    out: dict = {}
    for s, e, name in ops:
        row = out.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e9
    return out


def kernel(kernels: dict, fragment: str) -> tuple[int, float]:
    """(launches, seconds) of the device operations whose name holds
    `fragment` (a kernel's name in the trace carries its signature)."""
    rows = [v for k, v in kernels.items() if fragment in k]
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


CALL_NAMES = {True: "feed call that returns a chunk (copy, replays, fetch)",
              False: "feed call that returns nothing (the frame's copy)"}
BETWEEN_CALLS = "the harness, between feed calls"


def idle_gaps_by_call(ops, window) -> list:
    """[[what the host was doing, idle seconds], ...]: the device's idle
    gaps inside the pass, split over the benchmark's calls open during each
    (the window's clock must be the trace's, `time.time_ns`)."""
    t0, t1 = window.calls[0][0], window.calls[-1][1]
    spans = [(max(s, t0), min(e, t1)) for s, e in merged(ops)
             if e > t0 and s < t1]
    edges = [t0] + [x for s, e in spans for x in (s, e)] + [t1]
    starts = [c[0] for c in window.calls]
    out: dict = {}

    def add(name, ns):
        if ns > 0:
            out[name] = out.get(name, 0.0) + ns / 1e9

    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_NS:
            add(SHORT_GAP_NAME, b - a)
            continue
        # split the gap over the calls open during it
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        covered = 0
        while j < len(window.calls) and window.calls[j][0] < b:
            c0, c1, chunk = window.calls[j]
            part = min(b, c1) - max(a, c0)
            if part > 0:
                add(CALL_NAMES[chunk], part)
                covered += part
            j += 1
        add(BETWEEN_CALLS, (b - a) - covered)
    return top(out)


def top(rows: dict, n: int = 10) -> list:
    """[[name, seconds], ...], the n largest."""
    return [[k, v] for k, v in sorted(rows.items(), key=lambda kv: -kv[1])[:n]]


def device_pass(run: Callable[[], int]) -> dict:
    """Profile `run()` (which drives frames and returns how many) with the
    device's activities only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frames = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = device_ops(prof.profiler.kineto_results.events())
    kernels = by_name(ops)
    return {"frames": frames, "window_s": wall, "busy_s": busy_ns(ops) / 1e9,
            "device_ops": len(ops), "kernels": kernels, "ops": ops,
            "top_device_ops": top({k: v[1] for k, v in kernels.items()})}
