"""Liveness watchdog: detect a stalled frame pipeline.

Counterpart of `jetracer_orbslam2_tpu/runtime/liveness.py`, a copy of it
(standard library only).  The reference ships (but disables) a PingPong probe
thread that round-trips a 250 ms heartbeat over its event bus
(reference src/PingPong/PingPong.cpp:27-81, disabled at
MainEventsLoop.cpp:37-40).  The equivalent for a host-scheduled device
pipeline is a watchdog on the frame loop: the scheduler calls `beat()`
once per processed frame; a monitor thread flags when no beat has arrived
within the timeout (a wedged device dispatch, a stuck data source, a
deadlocked prefetch queue).  Stalls are reported via callback (default:
one warning log per stall episode) and counted for the run report.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class Watchdog:
    """Monitor thread that fires when `beat()` stops arriving.

    on_stall(seconds_since_last_beat) is called once per stall EPISODE
    (re-armed by the next beat), never more than once per check interval.
    """

    def __init__(self, timeout_s: float = 2.0,
                 on_stall: Optional[Callable[[float], None]] = None,
                 check_interval_s: Optional[float] = None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or self._log_stall
        self._interval = check_interval_s or max(timeout_s / 4.0, 0.01)
        self._last = time.monotonic()
        self._stalled = False
        self.stalls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _log_stall(age: float) -> None:
        log.warning("pipeline stalled: no frame for %.1f s", age)

    def start(self) -> "Watchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last = time.monotonic()
        self._stalled = False

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            age = time.monotonic() - self._last
            if age > self.timeout_s and not self._stalled:
                self._stalled = True
                self.stalls += 1
                try:
                    self.on_stall(age)
                except Exception:                     # never kill the monitor
                    log.exception("watchdog on_stall callback failed")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
