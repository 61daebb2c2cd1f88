"""The arithmetic of the end-to-end metrics, on the window's own records.

A chunk record is (t_call, t_return, frames): the host clock at the call
that handed the chunk's first frame, at the return of the call that handed
back its outputs, and how many frames it held.
"""

from __future__ import annotations

from typing import Sequence


def fps(chunks: Sequence[tuple], t_start: float, t_end: float) -> float:
    """Every frame whose output reached the host in the window, over all of
    the window's wall seconds (stalls and idle time included)."""
    return sum(c[2] for c in chunks) / (t_end - t_start)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def chunk_ms(chunks: Sequence[tuple]) -> list[float]:
    return [(c[1] - c[0]) * 1e3 for c in chunks]


def chunk_ms_p95(chunks: Sequence[tuple]) -> float:
    """95th percentile over every chunk of the window of its latency, from
    the call that hands its first frame to the return of its outputs."""
    return percentile(chunk_ms(chunks), 95.0)
