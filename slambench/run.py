#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `slambench/` and the
program (`jetracer_orbslam2_torch/`), on a machine with a CUDA device:

1. set-up: build the program's kernels if the checkout has none, render the
   cell's lap from the seed on the device and move it to host memory, build
   the program entry and run one untimed lap through it (`setup_s` is this
   time less the build's and the rendering's, both kept in `setup_parts`);
2. the window: hand frames in a closed loop for `--seconds`, timing each
   chunk on the host's clock;
3. with `--trace 1`: a device-only profiler pass and a host-and-device pass
   over frames after the window;
4. the check: the program's answers against the plain references;
5. the result: one JSON line, the last of standard output, with `correct`,
   `attempted`, `failed`, `metrics` (the end-to-end metrics, or with
   `--trace 1` the per-layer ones), `device`, with `--trace 1` `breakdown`,
   and last `checks` (each compared number with its limit, also the last
   lines of standard error).

Without a CUDA device, or with fewer than the cell asks for, it exits with 3
and prints no result; with JAX or the JAX package loaded, with 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jetracer_orbslam2_tpu")
NO_DEVICE, FORBIDDEN_LOADED = 3, 4


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def use_checkout_caches() -> None:
    """Every kernel cache inside the checkout, at fixed paths, so only the
    first run of a checkout builds; nothing lets a library load JAX."""
    cache = ROOT / ".slambench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among `names` (by default the
    process's loaded modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        name, limit = out.stdout.strip().splitlines()[0].split(", ")
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"name": None, "power_limit": None}


def run(cell, seed: int, seconds: float, trace_on: bool, device,
        t_start: float = T_START, make_entry=None, alter=None) -> dict:
    """Set up, measure, trace and check one run of `cell` on `device`;
    returns the result's fields (and `info`, printed apart).

    `make_entry(config, traffic, intrinsics, seed, device)` replaces the
    cell's entry and `alter(results, lap)` rewrites the program's answers
    before the check: the tests' controls and planted faults."""
    import numpy as np
    import torch

    from slambench.harness import check, native, stats, trace, traffic, window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    on_card = device.type == "cuda"
    entry_mod = cell.entry()
    native_s = native.build() if on_card else 0.0

    t_render = time.perf_counter()
    lap = traffic.make_lap(cell.config, cell.traffic, seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_warm = time.perf_counter()
    entry = (make_entry or entry_mod.Entry)(
        cell.config, cell.traffic, lap.intrinsics, traffic.seed_value(seed),
        device)
    chunk = int(cell.traffic["chunk_size"])
    warm = 1 + chunk * math.ceil((lap.frames - 1) / chunk)
    window.drive(entry, lap, 0, frames=warm)
    loops_before = entry.counters()["loops"]
    to_window = time.perf_counter() - t_start
    render_s = t_warm - t_render
    # the program's set-up: the build (a checkout's first run only) and the
    # benchmark's own rendering of its input are kept apart
    setup_s = to_window - native_s - render_s
    setup_parts = {"imports_s": t_render - t_start - native_s,
                   "native_build_s": native_s, "lap_render_s": render_s,
                   "warm_lap_s": to_window - (t_warm - t_start)}

    w = window.drive(entry, lap, warm, seconds=seconds)

    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    counters = entry.counters()
    rows_tracked = np.concatenate([r["tracked"] for r in w.rows])
    rows_kf = np.concatenate([r["is_kf"] for r in w.rows])
    info = {"workload": cell.name, "seed": seed, "chunks": len(w.chunks),
            "frames": int(rows_tracked.size), "window_s": w.t_end - w.t_start,
            "setup_s": setup_s, "setup_parts": setup_parts,
            "warm_frames": warm, "keyframes_in_window": int(rows_kf.sum()),
            "chunk_ms": {q: stats.percentile(stats.chunk_ms(w.chunks), p)
                         for q, p in (("p50", 50), ("p90", 90), ("p95", 95),
                                      ("p99", 99), ("max", 100))},
            "loops_in_window": counters["loops"] - loops_before,
            "laps_in_window": w.handed / lap.frames, "program": counters}

    traced = breakdown = None
    if trace_on:
        passes = []

        def frames():
            ww = window.drive(entry, lap, w.start + w.handed,
                              frames=cell.traffic["trace_frames"],
                              clock=time.time_ns)
            passes.append(ww)
            return ww.handed

        traced = trace.device_pass(frames)
        gaps = trace.idle_gaps_by_call(traced.pop("ops"), passes[0])
        kf_bodies = int(sum(r["is_kf"].sum() for r in passes[0].rows))
        info["trace"] = {
            "frames": traced["frames"], "busy_s": traced["busy_s"],
            "window_s": traced["window_s"], "device_ops": traced["device_ops"],
            "keyframe_bodies": kf_bodies,
            "k1_launches": trace.kernel(traced["kernels"],
                                        "fast_nms_pyramid_kernel")[0],
            "k2_launches": trace.kernel(traced["kernels"],
                                        "ba_assemble_kernel")[0]}
        breakdown = {"device_ops": traced["top_device_ops"],
                     "idle_gaps": gaps}

    results = entry.results()
    if alter is not None:
        results = alter(results, lap)
    entry.close()
    del entry
    numbers = check.compare(results, lap, w, cell, seed, device, loops_before,
                            counters["loops"])
    correct, checks = check.judge(numbers, cell.limits)

    ctx = {"config": cell.config, "traffic": cell.traffic, "setup_s": setup_s,
           "window": {"chunks": w.chunks, "t_start": w.t_start,
                      "t_end": w.t_end, "frames": int(rows_tracked.size),
                      "keyframes": int(rows_kf.sum())},
           "trace": traced,
           "device": {"kind": torch.cuda.get_device_name(device)
                      if on_card else "cpu"}}
    metrics = cell.read_metrics(cell.per_layer if trace_on else cell.end_to_end,
                                ctx)
    missing = w.handed - int(rows_tracked.size)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": ctx["device"]["kind"], "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
    result = {"correct": bool(correct), "attempted": int(w.handed),
              "failed": int((~rows_tracked).sum()) + missing,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "info": info}


def main(argv=None) -> int:
    args = parse(argv)
    use_checkout_caches()
    sys.path.insert(0, str(ROOT))
    from slambench.harness import spec

    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"slambench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return NO_DEVICE
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    info = out["info"]
    info["card"] = card()
    info["cpus"] = sorted(os.sched_getaffinity(0))
    print(json.dumps({"slambench": info}), flush=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"slambench: the process holds {', '.join(loaded)}: the "
              "benchmark may load neither JAX nor the JAX package",
              file=sys.stderr)
        return FORBIDDEN_LOADED
    result = out["result"]
    for name, c in result["checks"].items():
        op = "<=" if c["holds"] == "max" else ">="
        print(f"check {name} {c['value']!r} {op} {c['limit']!r}"
              + ("" if c["value"] is not None else " (no number: fails)"),
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
