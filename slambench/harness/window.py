"""The closed loop that feeds a program entry: the next frame is handed as
soon as the call before it returns, as a dataset is replayed or a robot
catches up.  Times are the host's clock around the calls the benchmark
makes, and nothing else: no synchronisation is added inside the window.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple


class Window(NamedTuple):
    t_start: float
    t_end: float
    start: int          # stream index of the window's first frame
    handed: int         # frames handed to the entry
    chunks: list        # (t_call, t_return, frames) of every returned chunk
    rows: list          # the entry's outputs, one dict a chunk
    calls: list         # (t_call, t_return, returned a chunk) of every call


def drive(entry, lap, start: int, seconds: float | None = None,
          frames: int | None = None,
          clock: Callable[[], float] = time.perf_counter) -> Window:
    """Hand stream frames start, start + 1, ... to `entry` until `seconds`
    have passed, or until `frames` frames have been handed, and stop at the
    first chunk that returns after that: every frame handed has come back.
    """
    chunks, rows, calls = [], [], []
    i = start
    t_call = None
    t_start = clock()
    while True:
        t = clock()
        if t_call is None:
            t_call = t
        out = entry.feed(*lap.frame(i))
        t_ret = clock()
        calls.append((t, t_ret, out is not None))
        i += 1
        if out is None:
            continue
        chunks.append((t_call, t_ret, len(out["tracked"])))
        rows.append(out)
        t_call = None
        if seconds is not None and t_ret - t_start >= seconds:
            break
        if frames is not None and i - start >= frames:
            break
    return Window(t_start, chunks[-1][1], start, i - start, chunks, rows, calls)
