"""Spans on the host's clock, and per-stage timing with min/max/avg statistics.

Counterpart of `jetracer_orbslam2_tpu/utils/timing.py` (the reference's
chrono spans around its GPU loop and vilib's Timer/Statistics).

`RECORDER` is the process's span recorder: each span is a name, its start
and end in `time.perf_counter_ns()`, its own id, the id of the span that
was open on its thread when it began (its parent), a request id (the chunk
it served) and one integer value (bytes moved, a device time in ns).  It
never waits for a device: a span around an asynchronous launch times the
enqueue.  Records go into a ring of fixed capacity; once it wraps, the
oldest are overwritten and counted (`overwritten`), and a query over an
interval they touched says it is incomplete.  Recording is always on;
`set_recording(False)` turns it off for the whole process.

The recorder keeps anchors, pairs of (`perf_counter_ns`, `time_ns`), one
taken at each request boundary (`new_request`), so that a span can be put
on the clock of a device trace (`time_ns`) with an error bounded by the
clocks' slew between two requests (`to_wall`).

CUDA work is asynchronous under PyTorch, so a timed section that must
include the device's work hands its outputs to `Timer.stop(result)`, which
waits for every CUDA device they lie on, as `jax.block_until_ready` does in
the JAX package.  `StageTimers` keeps each stage's statistics and writes
every timed section to the recorder as a span named `stage.<name>`.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import torch

CAPACITY = 1 << 17      # records: ~8 of the odometry cell's 20-s windows
ANCHORS = 1 << 15       # anchor pairs kept (one a request)


class Record(NamedTuple):
    name: str
    start_ns: int        # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int          # the id of the span open when it began; -1: none
    request: int         # -1: none
    value: int
    count: int           # events the record stands for: 1 for a span, the
    #                      replays that took a body for a body's record


class Spans(NamedTuple):
    """What `SpanRecorder.query` finds: the records' summed `count`, their
    summed durations and values, and whether no record that began in the
    interval was overwritten."""
    count: int
    total_ns: int
    value: int
    complete: bool


class SpanRecorder:
    """A process's spans in a ring of `capacity` records (see the module's
    docstring).  Thread-safe: each thread keeps its own stack of open spans;
    a record takes its slot from a counter and is stored by one list
    assignment (each atomic under the interpreter's lock), and what a
    record overwrites is noted under a lock."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.on = True
        self._ring: list = [None] * capacity
        self._slots = itertools.count()
        self._last = -1              # the latest slot taken
        self._lost_end = -1          # latest end of a record overwritten
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._requests = itertools.count()
        self._local = threading.local()
        self._anchors: collections.deque = collections.deque(maxlen=ANCHORS)
        self.anchor()

    # -- recording -------------------------------------------------------
    def begin(self, name: str, request: Optional[int] = None):
        """Open a span on this thread; None when recording is off.  Its
        parent is the thread's innermost open span, whose request it takes
        unless `request` is given."""
        if not self.on:
            return None
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._local.stack = []
        if stack:
            top = stack[-1]
            span = (name, next(self._ids), top[1],
                    top[3] if request is None else request,
                    time.perf_counter_ns())
        else:
            span = (name, next(self._ids), -1,
                    -1 if request is None else request, time.perf_counter_ns())
        stack.append(span)
        return span

    def end(self, span, value: int = 0) -> None:
        """Close `span` (from `begin`; None is ignored) with its value."""
        if span is None:
            return
        t1 = time.perf_counter_ns()
        stack = self._local.stack
        if stack[-1] is span:
            stack.pop()
        else:
            stack.remove(span)
        # `_store`, inlined: this is the path every span takes
        i = next(self._slots)
        j = i % self.capacity
        ring = self._ring
        if ring[j] is not None:
            self._note_lost(ring[j])
        ring[j] = (span[0], span[4], t1, span[1], span[2], span[3], value, 1)
        self._last = i

    def record(self, name: str, start_ns: int, end_ns: int, value: int = 0,
               count: int = 1, request: Optional[int] = None) -> None:
        """A finished record whose times the caller took (a warm-up, or a
        body's device time fetched with a chunk), inside the thread's open
        span, if any."""
        if not self.on:
            return
        stack = getattr(self._local, "stack", None)
        parent = stack[-1][1] if stack else -1
        if request is None:
            request = stack[-1][3] if stack else -1
        self._store((name, start_ns, end_ns, next(self._ids), parent, request,
                     value, count))

    def _store(self, rec: tuple) -> None:
        i = next(self._slots)
        j = i % self.capacity
        old = self._ring[j]
        if old is not None:
            self._note_lost(old)
        self._ring[j] = rec
        self._last = i

    def _note_lost(self, old: tuple) -> None:
        with self._lock:
            self._lost_end = max(self._lost_end, old[2])

    # -- requests and the trace's clock ------------------------------------
    def anchor(self) -> None:
        """Pair `perf_counter_ns` (the midpoint of two reads) with
        `time_ns`."""
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        self._anchors.append(((p0 + p1) // 2, wall))

    def new_request(self) -> int:
        """A new request id, process-wide, with a new anchor."""
        self.anchor()
        return next(self._requests)

    def to_wall(self, perf_ns: int) -> int:
        """`perf_ns` on the clock of `time.time_ns()` (a device trace's),
        through the latest anchor taken at or before it (the first anchor
        for an earlier time)."""
        anchors = list(self._anchors)
        i = max(bisect.bisect_right(anchors, (perf_ns, float("inf"))) - 1, 0)
        p, wall = anchors[i]
        return wall + (perf_ns - p)

    # -- reading -----------------------------------------------------------
    @property
    def overwritten(self) -> int:
        """Records overwritten since the recorder was made."""
        return max(0, self._last + 1 - self.capacity)

    def records(self, name: Optional[str] = None,
                start_ns: Optional[int] = None,
                end_ns: Optional[int] = None) -> list[Record]:
        """The records kept (of `name`, whose start lies in [start_ns,
        end_ns)), by start time."""
        ring = list(self._ring)
        lo = -1 if start_ns is None else start_ns
        out = [Record(*r) for r in ring if r is not None
               and (name is None or r[0] == name) and r[1] >= lo
               and (end_ns is None or r[1] < end_ns)]
        out.sort(key=lambda r: (r.start_ns, r.id))
        return out

    def query(self, name: str, start_ns: int, end_ns: int) -> Spans:
        """The records of `name` whose start lies in [start_ns, end_ns):
        their summed counts, durations and values."""
        rs = self.records(name, start_ns, end_ns)
        return Spans(sum(r.count for r in rs),
                     sum(r.end_ns - r.start_ns for r in rs),
                     sum(r.value for r in rs), self._lost_end < start_ns)

    def summary(self, start_ns: Optional[int] = None,
                end_ns: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        """For each name kept (of the records that start in [start_ns,
        end_ns)): records, summed counts, total, mean and p95 ms of the
        records' durations, and the summed values; for a body
        (`graph.body.<name>`) its time in ms, in all and a body taken."""
        by: Dict[str, list] = {}
        for r in self.records(None, start_ns, end_ns):
            by.setdefault(r.name, []).append(r)
        out = {}
        for name, rs in sorted(by.items()):
            ms = sorted((r.end_ns - r.start_ns) / 1e6 for r in rs)
            count = sum(r.count for r in rs)
            row = {"records": len(rs), "count": count, "total_ms": sum(ms),
                   "mean_ms": sum(ms) / len(ms),
                   "p95_ms": ms[min(len(ms) - 1, int(0.95 * len(ms)))],
                   "value": sum(r.value for r in rs)}
            if name.startswith("graph.body."):
                row["body_ms"] = row["value"] / 1e6
                row["body_ms_mean"] = row["body_ms"] / count if count else 0.0
            out[name] = row
        return out


RECORDER = SpanRecorder()


def set_recording(on: bool) -> None:
    """Turn the process's span recording on or off."""
    RECORDER.on = bool(on)


@dataclass
class Stats:
    n: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    # FramePipeline's workers add to one Stats from several threads
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    def add(self, dt: float) -> None:
        with self._lock:
            self.n += 1
            self.total += dt
            self.min = min(self.min, dt)
            self.max = max(self.max, dt)

    @property
    def avg(self) -> float:
        return self.total / self.n if self.n else 0.0

    def summary(self) -> Dict[str, float]:
        return {"n": self.n, "avg_ms": self.avg * 1e3,
                "min_ms": (0.0 if self.n == 0 else self.min * 1e3),
                "max_ms": self.max * 1e3}


def _cuda_devices(result: Any, out: set) -> set:
    """The CUDA devices of every tensor in `result` (a tensor, or a tuple,
    NamedTuple, list or dict of them, nested)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            out.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _cuda_devices(v, out)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _cuda_devices(v, out)
    return out


class Timer:
    """Context-manager or start/stop timer that waits for device results;
    with a `name`, each stop is also a span of the recorder."""

    def __init__(self, stats: Stats | None = None, name: str | None = None):
        self.stats = stats or Stats()
        self.name = name
        self._t0 = 0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter_ns()
        return self

    def stop(self, result: Any = None) -> float:
        """Record the time since `start`; first wait for each CUDA device
        that holds a tensor of `result` (CPU tensors and None need no wait)."""
        for dev in _cuda_devices(result, set()):
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter_ns()
        dt = (t1 - self._t0) / 1e9
        self.stats.add(dt)
        if self.name is not None:
            RECORDER.record(self.name, self._t0, t1)
        return dt

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@dataclass
class StageTimers:
    """Named per-stage timers: an explicit object, not global state.  Each
    timed section is also a span `stage.<name>` of the recorder."""

    stages: Dict[str, Stats] = field(default_factory=dict)

    def timer(self, name: str) -> Timer:
        stats = self.stages.setdefault(name, Stats())
        return Timer(stats, name="stage." + name)

    def time(self, name: str, fn, *args, **kwargs):
        t = self.timer(name).start()
        out = fn(*args, **kwargs)
        t.stop(out)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: v.summary() for k, v in self.stages.items()}
