"""The readers of the program's spans on a fabricated window (on the CPU),
and the spans against the device trace on the card (`-m card`): a replay's
device work starts after its `graph.replay` span starts, a chunk's work ends
before its last `entry.fetch` span ends, and a keyframe body's device time
covers its K2 launches."""

import time

import pytest
import torch

from slambench.harness import native, spec, trace, traffic, window

SPAN_READERS = ("entry.host_us_per_frame", "entry.copy_us_per_frame",
                "graph.enqueue_us_per_frame", "entry.fetch_ms_per_chunk",
                "entry.host_waits_per_chunk", "scan.keyframe_body_ms",
                "scan.loop_body_ms")
US, MS, S = 1_000, 1_000_000, 1_000_000_000
# the spans and the trace on one clock: the anchors' error, the trace's
TOLERANCE_NS = 20 * US


def _read(name, ctx):
    return spec.load_module("metrics", name).read(ctx)


def _window(frames=16, chunks=2):
    """A window from 10 s to 11 s on the host's clock."""
    return {"window": {"t_start": 10.0, "t_end": 11.0, "frames": frames,
                       "chunks": [(10.0, 10.5, frames // chunks)] * chunks,
                       "keyframes": 0}}


@pytest.fixture
def recorder(monkeypatch):
    from jetracer_orbslam2_torch.utils import timing

    rec = timing.SpanRecorder(capacity=1024)
    monkeypatch.setattr(timing, "RECORDER", rec)
    return rec


def test_the_span_readers_read_the_window_alone(recorder):
    at = 10 * S
    for i in range(16):
        t = at + i * MS
        recorder.record("entry.frame", t, t + 100 * US)
        recorder.record("entry.copy", t + 10 * US, t + 60 * US, value=8)
        recorder.record("graph.replay", t + 200 * US, t + 220 * US)
    for k in range(2):
        t = at + 500 * MS + k * 100 * MS
        recorder.record("entry.chunk", t, t + 3 * MS)
        recorder.record("entry.fetch", t + MS, t + 2 * MS, value=4)
        recorder.record("entry.fetch", t + 2 * MS, t + 3 * MS, value=4)
    recorder.record("graph.body.keyframe", at + 510 * MS, at + 520 * MS,
                    value=3 * MS, count=1)
    recorder.record("graph.body.keyframe", at + 610 * MS, at + 620 * MS,
                    value=6 * MS, count=2)
    # outside the window: before it and from its end on
    for t in (at - MS, 11 * S, 12 * S):
        for name in ("entry.frame", "entry.copy", "graph.replay",
                     "entry.chunk", "entry.fetch", "graph.body.keyframe",
                     "graph.body.loop_closure"):
            recorder.record(name, t, t + 50 * MS, value=99 * MS, count=5)
    ctx = _window()
    got = {name: _read(name, ctx) for name in SPAN_READERS}
    assert got["entry.host_us_per_frame"] == pytest.approx((16 * 100 + 2 * 3000)
                                                           / 16)
    assert got["entry.copy_us_per_frame"] == pytest.approx(50.0)
    assert got["graph.enqueue_us_per_frame"] == pytest.approx(20.0)
    assert got["entry.fetch_ms_per_chunk"] == pytest.approx(2.0)
    assert got["entry.host_waits_per_chunk"] == 2.0
    assert got["scan.keyframe_body_ms"] == pytest.approx(3.0)
    assert got["scan.loop_body_ms"] is None      # no loop in the window


def test_the_span_readers_find_nothing_without_spans(recorder, monkeypatch):
    from jetracer_orbslam2_torch.utils import timing

    ctx = _window()
    assert all(_read(name, ctx) is None for name in SPAN_READERS)
    # a window whose records the ring overwrote is not read
    small = timing.SpanRecorder(capacity=4)
    monkeypatch.setattr(timing, "RECORDER", small)
    for i in range(8):
        small.record("entry.copy", 10 * S + i * MS, 10 * S + i * MS + 1)
    assert _read("entry.copy_us_per_frame", ctx) is None
    # a program without the recorder (as before it had one)
    monkeypatch.delattr(timing, "RECORDER")
    assert all(_read(name, ctx) is None for name in SPAN_READERS)


def _traced(entry, lap, start, frames):
    """Drive `frames` frames under a device-only profiler pass: (the
    device's operations on the trace's clock, the pass's host interval)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        window.drive(entry, lap, start, frames=frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    return trace.device_ops(prof.profiler.kineto_results.events()), t0, t1


def _entry(config, mix, entry_name, seed, device):
    native.build()
    lap = traffic.make_lap(config, mix, seed, device)
    make = spec.load_module("entries", entry_name).Entry
    entry = make(config, mix, lap.intrinsics, traffic.seed_value(seed), device)
    warm = 1 + 8 * int(mix["chunk_size"])
    window.drive(entry, lap, 0, frames=warm)       # the capture, untraced
    return entry, lap, warm


@pytest.mark.card
def test_the_odometry_spans_bound_the_trace(card):
    """On the cell's own sizes: each replay's K1 launch (one a replay)
    starts after its `graph.replay` span starts, and every device operation
    launched before a chunk's last `entry.fetch` returned has ended by
    then, on the trace's clock through the recorder's anchors."""
    from jetracer_orbslam2_torch.utils.timing import RECORDER

    cell = spec.load("tum-rgbd.desk-odometry")
    entry, lap, warm = _entry(cell.config, cell.traffic, "chunked_odometry",
                              3_700_000_013, card)
    ops, t0, t1 = _traced(entry, lap, warm, 8 * 16)
    entry.close()
    wall = RECORDER.to_wall
    replays = RECORDER.records("graph.replay", t0, t1)
    k1 = [op for op in ops if "fast_nms_pyramid_kernel" in op[2]]
    assert len(replays) == len(k1) == 8 * 16
    early = [(op[0] - wall(r.start_ns)) / 1e3 for r, op in zip(replays, k1)
             if op[0] < wall(r.start_ns) - TOLERANCE_NS]
    assert not early, f"K1 launches before their replay's span, us: {early}"
    chunks = RECORDER.records("entry.chunk", t0, t1)
    fetches = RECORDER.records("entry.fetch", t0, t1)
    assert len(chunks) == 16 and len(fetches) == 2 * len(chunks)
    late = []
    for c in chunks:
        end = wall(max(f.end_ns for f in fetches if f.parent == c.id))
        late += [(op[1] - end) / 1e3 for op in ops
                 if op[0] < end and op[1] > end + TOLERANCE_NS]
    assert not late, f"operations ending after their chunk's fetch, us: {late}"


@pytest.mark.card
def test_a_keyframe_body_covers_its_k2_launches(card):
    """A SLAM lap at the RGB-D rig's sizes: each chunk's keyframe-body time
    (the frame graph's clock marks, fetched with the chunk) is at least the
    device time the trace gives the chunk's K2 launches, and every chunk
    with K2 launches took the body."""
    from jetracer_orbslam2_torch.utils.timing import RECORDER

    config = spec.read_json("configs", "tum-rgbd-640x480")
    mix = spec.read_json("traffic", "desk-lap")
    entry, lap, warm = _entry(config, mix, "chunked_slam", 3_700_000_031, card)
    ops, t0, t1 = _traced(entry, lap, warm, 8 * 16)
    entry.close()
    wall = RECORDER.to_wall
    bodies = {r.request: r for r in RECORDER.records("graph.body.keyframe",
                                                     t0, t1)}
    assert bodies, "no keyframe body in 128 frames"
    rows = []
    for c in RECORDER.records("entry.chunk", t0, t1):
        a, b = wall(c.start_ns), wall(c.end_ns)
        k2 = sum(op[1] - op[0] for op in ops if a <= op[0] < b and (
            "ba_assemble_kernel" in op[2] or "ba_reduce_kernel" in op[2]))
        body = bodies.get(c.request)
        rows.append((c.request, k2, body and (body.count, body.value)))
        assert (body is None) == (k2 == 0), rows[-1]
        if body is not None:
            assert body.value >= k2 > 0, rows[-1]
    print("chunk, K2 ns, (bodies, body ns):", rows)
