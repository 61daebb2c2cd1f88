#!/usr/bin/env python3
"""What the span recorder (`utils/timing.RECORDER`) and the frame graph's
body clock marks cost, and what the spans of the odometry cell read.

    python3 scripts/bench_torch_spans.py [--seconds S] [--pairs N]

1. The odometry cell (`tum-rgbd.desk-odometry`, `slambench.run.run`), N
   pairs of runs of S seconds in one process, recording on and off in turns
   (on, off, off, on, ...), a seed a pair: `fps`, `chunk_ms_p95`, and with
   recording on the five span readers over each window.
2. Host ns a span: `begin` + `end` pairs and `record` calls, recording on
   and off, 200,000 of each, best of 5 (the host's clock).
3. Device cost of the marks: a frame graph whose one `cond` body holds
   nothing, replayed 200 times with the body taken and 200 times not, in
   turns, timed with CUDA events (µs a replay); the µs the marks read for
   the empty body (`FrameGraph.branch_counts`); and from a device trace of
   50 taken replays each mark kernel's µs and the median µs from the first
   mark's start to the second's end.

Prints the card's name and power limit first and one JSON line last; exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

READERS = ("entry.host_us_per_frame", "entry.copy_us_per_frame",
           "graph.enqueue_us_per_frame", "entry.fetch_ms_per_chunk",
           "entry.host_waits_per_chunk")


def span_cost(n: int = 200_000) -> dict:
    from jetracer_orbslam2_torch.utils import timing

    rec = timing.SpanRecorder()
    out = {}
    for on in (True, False):
        rec.on = on
        pair, made = [], []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                rec.end(rec.begin("x"), 1)
            t1 = time.perf_counter_ns()
            for _ in range(n):
                rec.record("y", t0, t1, 1)
            t2 = time.perf_counter_ns()
            pair.append((t1 - t0) / n)
            made.append((t2 - t1) / n)
        key = "on" if on else "off"
        out[f"begin_end_ns_{key}"] = min(pair)
        out[f"record_ns_{key}"] = min(made)
    return out


def mark_cost(dev, replays: int = 200) -> dict:
    import torch

    from jetracer_orbslam2_torch.utils import step_graph

    def fn(gen, carry, flag):
        step_graph.cond(flag, lambda: None, name="empty")
        return carry[0] + 1

    g = step_graph.FrameGraph(fn, None)
    carry = (torch.zeros(4, device=dev),)
    flags = {v: torch.tensor(v, device=dev) for v in (True, False)}
    g(carry, flags[True])               # warm-up and capture
    carry = tuple(g.carry())
    g.settle()
    us = {True: [], False: []}
    for turn in (True, False, False, True):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            g(carry, flags[turn])
            carry = tuple(g.carry())
        stop.record()
        stop.synchronize()
        us[turn].append(start.elapsed_time(stop) * 1e3 / replays)
        if turn:
            counts = g.branch_counts().cpu().numpy()
            g.settle(counts)
            us.setdefault("marks", []).append(int(counts[1][0]) / 1e3
                                              / int(counts[0][0]))
        else:
            g.settle()
    # the marks' own device time, from a device trace of 50 taken replays
    from torch.profiler import ProfilerActivity, profile

    from slambench.harness import trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            g(carry, flags[True])
            carry = tuple(g.carry())
        torch.cuda.synchronize()
    g.settle()
    ops = trace.device_ops(prof.profiler.kineto_results.events())
    marks = [op for op in ops if "body_mark_kernel" in op[2]]
    body = [(b[1] - a[0]) / 1e3 for a, b in zip(marks[0::2], marks[1::2])]
    return {"replay_us_taken": us[True], "replay_us_not_taken": us[False],
            "empty_body_marks_us": us["marks"],
            "mark_kernels": len(marks),
            "mark_kernel_us": (sum(op[1] - op[0] for op in marks) / 1e3
                               / max(len(marks), 1)),
            "empty_body_device_us": sorted(body)[len(body) // 2] if body
            else None,
            "body_nodes": g.body_nodes, "graph_nodes": g.graph_nodes}


def cell_pairs(dev, seconds: float, pairs: int) -> list:
    from jetracer_orbslam2_torch.utils import timing
    from slambench import run as run_mod
    from slambench.harness import spec, window

    cell = spec.load("tum-rgbd.desk-odometry")
    windows = []
    drive = window.drive

    def kept(*a, **kw):             # the run's windows, for the readers
        w = drive(*a, **kw)
        windows.append(w)
        return w

    window.drive = kept
    rows = []
    for k in range(pairs):
        seed = 3_800_000_000 + 1_000_003 * k
        for on in ((True, False) if k % 2 == 0 else (False, True)):
            timing.set_recording(on)
            t0 = time.perf_counter()
            out = run_mod.run(cell, seed, seconds, False, dev)
            timing.set_recording(True)
            res, info = out["result"], out["info"]
            row = {"pair": k, "seed": seed, "recording": on,
                   "correct": res["correct"], "wall_s": time.perf_counter() - t0,
                   **{m: v["value"] for m, v in res["metrics"].items()}}
            if on:
                w = windows[-1]             # the measured window
                ctx = {"window": {"t_start": w.t_start, "t_end": w.t_end,
                                  "frames": info["frames"],
                                  "chunks": w.chunks}}
                for name in READERS:
                    row[name] = spec.load_module("metrics", name).read(ctx)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--pairs", type=int, default=4)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_spans: needs a CUDA device", file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    from slambench.harness import native

    native.build()
    report = {"card": card}
    # the cell first: a profiler pass earlier in the process (the marks'
    # below) leaves every later launch slower on the host
    if args.pairs:
        report["cell"] = cell_pairs(dev, args.seconds, args.pairs)
    report["span_cost"] = span_cost()
    print(json.dumps(report["span_cost"]), flush=True)
    report["mark_cost"] = mark_cost(dev)
    print(json.dumps(report["mark_cost"]), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
