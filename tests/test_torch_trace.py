"""The span recorder (`utils/timing.py`) and the spans the entries and the
graphs record, on the CPU: nesting, parents, request ids, the ring's
wrap-around, interval queries, anchors, threads; `ChunkedOdometry`'s and
`ChunkedSlam`'s spans on tiny sequences; recording turned off."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.config import (
    FrontendConfig, MapConfig, SystemConfig, TrackingConfig)
from jetracer_orbslam2_torch.io.synthetic import generate_sequence
from jetracer_orbslam2_torch.models import odometry as todom
from jetracer_orbslam2_torch.models import slam_scan as ss
from jetracer_orbslam2_torch.runtime import FramePipeline
from jetracer_orbslam2_torch.utils import step_graph, timing
from jetracer_orbslam2_torch.utils.timing import RECORDER, SpanRecorder

H, W = 120, 160
FCFG = FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=256)
SLAM_CFG = SystemConfig(
    frontend=FCFG,
    map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                  kf_min_gap=2, kf_max_gap=4, window_size=4))


@pytest.fixture(scope="module")
def arc():
    seq = generate_sequence(n_frames=17, shape=(H, W), device="cpu")
    return seq.gray.numpy(), seq.depth.numpy(), seq.intrinsics.numpy()


def _by_id(records) -> dict:
    return {r.id: r for r in records}


def test_spans_nest_with_parents_and_requests():
    rec = SpanRecorder(capacity=64)
    req = rec.new_request()
    outer = rec.begin("outer", req)
    inner = rec.begin("inner")
    rec.record("made", 5, 9, value=3, count=2)
    rec.end(inner, 7)
    rec.end(outer)
    top = rec.begin("top")
    rec.end(top)
    rs = {r.name: r for r in rec.records()}
    assert rs["outer"].parent == -1 and rs["outer"].request == req
    assert rs["inner"].parent == rs["outer"].id
    assert rs["inner"].request == req and rs["inner"].value == 7
    assert rs["made"].parent == rs["inner"].id and rs["made"].request == req
    assert (rs["made"].start_ns, rs["made"].end_ns, rs["made"].count) == (5, 9, 2)
    assert rs["top"].parent == -1 and rs["top"].request == -1
    assert (rs["outer"].start_ns <= rs["inner"].start_ns
            <= rs["inner"].end_ns <= rs["outer"].end_ns)
    assert rec.new_request() == req + 1


def test_the_ring_wraps_and_counts_what_it_overwrote():
    rec = SpanRecorder(capacity=8)
    for i in range(20):
        rec.record("x", 100 * i, 100 * i + 10, value=i)
    assert rec.overwritten == 12
    kept = rec.records("x")
    assert [r.value for r in kept] == list(range(12, 20))
    # an interval whose records were all kept is complete; one that reaches
    # back over overwritten records is not
    assert rec.query("x", 1200, 2000) == timing.Spans(8, 80, sum(range(12, 20)),
                                                      True)
    assert not rec.query("x", 0, 2000).complete


def test_a_query_counts_the_records_that_start_in_the_interval():
    rec = SpanRecorder(capacity=64)
    rec.record("a", 10, 20, value=1)
    rec.record("a", 20, 45, value=2, count=3)
    rec.record("a", 30, 31, value=4)
    rec.record("b", 25, 26, value=8)
    assert rec.query("a", 20, 31) == timing.Spans(4, 26, 6, True)
    assert rec.query("a", 0, 100) == timing.Spans(5, 36, 7, True)
    assert rec.query("a", 100, 200) == timing.Spans(0, 0, 0, True)
    s = rec.summary(0, 100)
    assert s["a"]["records"] == 3 and s["a"]["count"] == 5
    assert s["a"]["total_ms"] == pytest.approx(36e-6)
    assert s["a"]["value"] == 7 and "body_ms" not in s["a"]
    rec.record("graph.body.keyframe", 50, 60, value=4_000_000, count=2)
    s = rec.summary()
    assert s["graph.body.keyframe"]["body_ms"] == pytest.approx(4.0)
    assert s["graph.body.keyframe"]["body_ms_mean"] == pytest.approx(2.0)


def test_anchors_put_a_span_on_the_clock_of_the_trace():
    rec = SpanRecorder(capacity=8)
    rec.new_request()
    p, wall = time.perf_counter_ns(), time.time_ns()
    # one anchor's error: the clocks' slew since it and the reads' spacing
    assert abs(rec.to_wall(p) - wall) < 5_000_000
    # an earlier time than every anchor goes through the first
    first_p, first_wall = rec._anchors[0]
    assert rec.to_wall(first_p - 1000) == first_wall - 1000


def test_threads_record_with_their_own_parents():
    rec = SpanRecorder(capacity=1 << 12)
    threads, per = 8, 100
    barrier = threading.Barrier(threads)
    old = sys.getswitchinterval()

    def work(k):
        barrier.wait(timeout=10)
        for i in range(per):
            outer = rec.begin(f"t{k}", request=k)
            inner = rec.begin("inner")
            rec.end(inner, k)
            rec.end(outer)

    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    rs = rec.records()
    assert len(rs) == 2 * threads * per and rec.overwritten == 0
    assert len({r.id for r in rs}) == len(rs)
    ids = _by_id(rs)
    for r in rs:
        if r.name == "inner":
            parent = ids[r.parent]
            assert parent.name == f"t{r.value}" and r.request == r.value
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns


def test_stage_timers_and_the_pipeline_land_in_the_recorder():
    t0 = time.perf_counter_ns()
    timers = timing.StageTimers()
    with timers.timer("plan"):
        pass
    out = list(FramePipeline(range(6), transform=lambda i: i * 2,
                             num_workers=2))
    assert out == [0, 2, 4, 6, 8, 10]
    assert RECORDER.query("stage.plan", t0, time.perf_counter_ns()).count == 1
    assert RECORDER.query("stage.decode", t0, time.perf_counter_ns()).count == 6


def test_a_host_branch_is_a_body_span():
    t0 = time.perf_counter_ns()
    ran = []
    step_graph.cond(1, lambda: ran.append(1), name="probe")
    step_graph.cond(0, lambda: ran.append(0), name="probe")
    step_graph.cond(torch.tensor(True), lambda: ran.append(2), name="probe")
    rs = RECORDER.records("graph.body.probe", t0)
    assert ran == [1, 2] and len(rs) == 2
    assert all(0 < r.value <= r.end_ns - r.start_ns for r in rs)


def test_chunked_odometry_spans(arc):
    gray, depth, intr = arc
    t0 = time.perf_counter_ns()
    ch = todom.ChunkedOdometry(torch.from_numpy(intr), FCFG, TrackingConfig(),
                               chunk_size=8, device="cpu")
    for i in range(gray.shape[0]):
        ch.process_frame(gray[i], depth[i])
    t1 = time.perf_counter_ns()
    rs = RECORDER.records(None, t0, t1)
    ids = _by_id(rs)
    named = {n: [r for r in rs if r.name == n] for n in
             ("entry.frame", "entry.copy", "entry.chunk", "entry.stack",
              "entry.fetch", "graph.replay")}
    assert len(named["entry.frame"]) == 17
    # one copy a frame after the first (the bootstrap), the frame's bytes
    assert len(named["entry.copy"]) == 16
    assert all(r.value == 2 * H * W * 4 for r in named["entry.copy"])
    assert all(ids[r.parent].name == "entry.frame" for r in named["entry.copy"])
    # each frame replays in the call that hands it in: its replay inside its
    # frame's span, after its copy
    replays = named["graph.replay"]
    assert len(replays) == 16
    for r in replays:
        f = ids[r.parent]
        assert f.name == "entry.frame" and r.request == f.request
        assert f.start_ns <= r.start_ns <= r.end_ns <= f.end_ns
        copy = [c for c in named["entry.copy"] if c.parent == f.id]
        assert len(copy) == 1 and copy[0].end_ns <= r.start_ns
    chunks = named["entry.chunk"]
    assert len(chunks) == 2 and named["entry.stack"] == []
    for c in chunks:
        assert sum(r.request == c.request for r in replays) == 8
        inside = [r for r in named["entry.fetch"] if r.parent == c.id]
        assert len(inside) == 2
        assert all(c.start_ns <= r.start_ns <= r.end_ns <= c.end_ns
                   and r.request == c.request for r in inside)
    assert sum(r.value for r in named["entry.fetch"]) == 16 * (16 * 4 + 1)
    # a frame's request is the chunk it belongs to (the bootstrap frame's,
    # the first chunk's); each chunk its own
    assert chunks[0].request != chunks[1].request
    assert [sum(r.request == c.request for r in named["entry.frame"])
            for c in chunks] == [9, 8]
    # the frame's span ends before the chunk it completes begins
    assert all(not (f.start_ns < c.start_ns < f.end_ns)
               for f in named["entry.frame"] for c in chunks)


def test_chunked_slam_spans(arc):
    gray, depth, intr = arc
    t0 = time.perf_counter_ns()
    ch = ss.ChunkedSlam(SLAM_CFG, intr, chunk_size=8, device="cpu")
    outs = [ch.process_frame(gray[i], depth[i]) for i in range(17)]
    outs = [o for o in outs if o is not None]
    rs = RECORDER.records(None, t0, time.perf_counter_ns())
    chunks = [r for r in rs if r.name == "entry.chunk"]
    assert len(outs) == len(chunks) == 2
    fetches = [r for r in rs if r.name == "entry.fetch"]
    assert sorted(r.parent for r in fetches) == sorted(c.id for c in chunks)
    for c, out in zip(chunks, outs):
        kf = [r for r in rs if r.name == "graph.body.keyframe"
              and r.request == c.request]
        # the CPU's host branches: one span a body taken, inside its replay
        assert sum(r.count for r in kf) == int(out.is_kf.sum()) >= 1
        assert all(_parent_name(rs, r) == "graph.replay" for r in kf)
    loops = [r for r in rs if r.name == "graph.body.loop_closure"]
    assert sum(r.count for r in loops) == int(ch.state.num_loops)
    assert sum(r.name == "graph.replay" for r in rs) == 16


def _parent_name(rs, r) -> str:
    return _by_id(rs)[r.parent].name


def test_recording_off_records_nothing(arc):
    gray, depth, intr = arc
    t0 = time.perf_counter_ns()
    timing.set_recording(False)
    try:
        ch = todom.ChunkedOdometry(torch.from_numpy(intr), FCFG,
                                   TrackingConfig(), chunk_size=4,
                                   device="cpu")
        for i in range(5):
            ch.process_frame(gray[i], depth[i])
        step_graph.cond(1, lambda: None, name="off")
        with timing.StageTimers().timer("off"):
            pass
    finally:
        timing.set_recording(True)
    assert ch.result()[0].shape == (5, 4, 4)
    assert RECORDER.records(None, t0, time.perf_counter_ns()) == []


def test_cli_json_reports_spans(capsys):
    rc = trun.main(["--synthetic", "7", "--mode", "odometry", "--device", "cpu",
                    "--levels", "2", "--max-keypoints", "256", "--json",
                    "--chunked", "3"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spans = report["spans"]
    assert spans["entry.chunk"]["count"] == 2 and spans["entry.fetch"]["count"] == 4
    assert spans["graph.replay"]["count"] == 6
    for row in spans.values():
        assert row["p95_ms"] <= row["total_ms"] + 1e-9 and row["mean_ms"] >= 0
    assert np.isclose(spans["entry.copy"]["value"], 6 * 2 * 4 * 480 * 640)
