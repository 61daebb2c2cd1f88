"""The end-to-end arithmetic on fixed timings: all frames over all of the
window's time, and the tail of all chunks."""

import statistics

import pytest

from slambench.harness import stats


def _chunks(latencies_ms, frames=8, gap_s=0.0, t0=0.0):
    out, t = [], t0
    for ms in latencies_ms:
        out.append((t, t + ms / 1e3, frames))
        t += ms / 1e3 + gap_s
    return out


def test_fps_counts_every_frame_over_the_whole_window():
    chunks = _chunks([25.0] * 40)
    assert stats.fps(chunks, 0.0, 1.0) == pytest.approx(320.0)


def test_fps_keeps_a_stall_in_the_window():
    """A stall between chunks (a host hiccup, a slow fetch) is time of the
    window: the rate falls, it is not taken over the chunks' own times."""
    chunks = _chunks([25.0] * 20) + _chunks([25.0] * 20, t0=0.5 + 0.5)
    t_end = chunks[-1][1]
    assert t_end == pytest.approx(1.5)
    assert stats.fps(chunks, 0.0, t_end) == pytest.approx(320 / 1.5)
    assert stats.fps(chunks, 0.0, t_end) < 320 / (40 * 0.025)


def test_p95_is_the_tail_of_all_chunks():
    """One run's chunks, 5 % of them 60 ms and the rest 25 ms: the tail of
    the whole set, not a median of per-piece percentiles."""
    lat = [25.0] * 190 + [60.0] * 10
    chunks = _chunks(lat)
    assert stats.chunk_ms_p95(chunks) == pytest.approx(
        25.0 + (60.0 - 25.0) * ((199 * 0.95) - 189))
    pieces = [stats.chunk_ms_p95(chunks[i:i + 50]) for i in range(0, 200, 50)]
    assert statistics.median(pieces) == pytest.approx(25.0)
    assert stats.chunk_ms_p95(chunks) > statistics.median(pieces)


def test_p95_with_a_stall():
    lat = [25.0] * 99 + [900.0]
    assert stats.chunk_ms_p95(_chunks(lat)) == pytest.approx(25.0)
    lat = [25.0] * 90 + [900.0] * 10
    assert stats.chunk_ms_p95(_chunks(lat)) == pytest.approx(900.0)


def test_percentile_is_numpys_linear():
    np = pytest.importorskip("numpy")
    values = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    for q in (0, 5, 50, 95, 100):
        assert stats.percentile(values, q) == pytest.approx(
            float(np.percentile(values, q)))
