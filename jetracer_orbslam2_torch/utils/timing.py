"""Per-stage wall-clock timing with min/max/avg statistics.

Counterpart of `jetracer_orbslam2_tpu/utils/timing.py` (the reference's
chrono spans around its GPU loop and vilib's Timer/Statistics).  CUDA work is
asynchronous under PyTorch, so a timed section that must include the device's
work hands its outputs to `Timer.stop(result)`, which waits for every CUDA
device they lie on, as `jax.block_until_ready` does in the JAX package.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict

import torch


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
    """Context-manager or start/stop timer that waits for device results."""

    def __init__(self, stats: Stats | None = None):
        self.stats = stats or Stats()
        self._t0 = 0.0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, result: Any = None) -> float:
        """Record the time since `start`; first wait for each CUDA device
        that holds a tensor of `result` (CPU tensors and None need no wait)."""
        for dev in _cuda_devices(result, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.stats.add(dt)
        return dt

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@dataclass
class StageTimers:
    """Named per-stage timers: an explicit object, not global state."""

    stages: Dict[str, Stats] = field(default_factory=dict)

    def timer(self, name: str) -> Timer:
        stats = self.stages.setdefault(name, Stats())
        return Timer(stats)

    def time(self, name: str, fn, *args, **kwargs):
        t = self.timer(name).start()
        out = fn(*args, **kwargs)
        t.stop(out)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: v.summary() for k, v in self.stages.items()}
