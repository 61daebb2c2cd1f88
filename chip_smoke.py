#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # 120 frames of 640x480, one GPU

Drives `jetracer_orbslam2_torch`'s main path — RGB-D odometry on a synthetic
640x480 sequence at the CLI's defaults (4 pyramid levels, 1024 keypoints, 256
RANSAC hypotheses) — through the functions `python -m
jetracer_orbslam2_torch.run --synthetic N --mode odometry` calls, builds the
hand-written CUDA kernel from the source in this checkout, holds it against
its plain PyTorch version, shows that the main path launched it, and times it.

Phases (any failure ends the run with a non-zero exit; there is no CPU path):
  1 device       a CUDA device must be present; prints the card's name and
                 power limit as nvidia-smi gives them
  2 build        nvcc compiles csrc/fast_nms.cu; prints seconds and ptxas' note
  3 kernel       kernel vs plain version, torch.equal, at every listed shape
  4 semantics    tie orders and CPU/GPU agreement of the front-end (small input)
  5 main path    whole-sequence odometry: ATE, tracked fraction, kernel
                 launches; --chunked 32 on the same frames gives the same
                 poses; a second, warm run is timed
  6 kernel time  median device time per launch at the four level shapes
                 (launches replayed from a CUDA graph), beside the card's bound
                 and the plain version's time
Then the main path's report, one JSON line `{"kernels": [...]}`, and as the
last line `{"ok": true, "device": {...}}`.

Imports torch and the port only — no JAX, nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the roofline
# the kernel's bound is computed against.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FAST_THRESHOLD, FAST_ARC, FAST_BORDER = 13.0, 12, 19
N_FRAMES = 120


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_event_ms(run, reps: int, per_run: int) -> float:
    """Median over `reps` of (CUDA-event time of one `run()`) / per_run, ms."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_run)
    return statistics.median(times)


def time_launches(fn, reps: int, batch: int) -> float:
    """Device ms per call of `fn`: `batch` calls captured into one CUDA graph
    and replayed, so the host's per-call cost drops out and the card's own
    time remains."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, reps, batch)


def fast_nms_work(img, threshold: float, border: int) -> tuple[int, int]:
    """(bytes, f32 operations) the FAST+NMS function needs on THIS image:
    each input read once and each output written once; per scored pixel 16
    subtractions and 32 compares, 2 more per ring pixel that passes +-t
    (counted from the data), and 9 compares per pixel for the 3x3 max."""
    from jetracer_orbslam2_torch.ops.fast import RING_OFFSETS

    h, w = img.shape
    b = border
    scored = max(h - 2 * b, 0) * max(w - 2 * b, 0)
    passes = 0
    if scored:
        c = img[b:h - b, b:w - b]
        for dy, dx in RING_OFFSETS:
            d = img[b + dy:h - b + dy, b + dx:w - b + dx] - c
            passes += int((d.abs() > threshold).sum())
    return 8 * h * w, scored * 48 + 2 * passes + 9 * h * w


def phase_kernel_checks(levels) -> tuple[float, bool]:
    """Kernel vs plain version, bit for bit.  Returns the max abs error seen
    and whether every comparison was torch.equal."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.ops import fused_fast

    dev = levels[0].device

    def integer_image(shape, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(
            rng.integers(0, 256, shape).astype(np.float32)).to(dev)

    cases = [(f"level{i} {tuple(l.shape)}", l.contiguous(), FAST_THRESHOLD,
              FAST_ARC, FAST_BORDER) for i, l in enumerate(levels)]
    for arc in (9, 12, 16):
        cases.append((f"(64,128) arc {arc}", integer_image((64, 128), 0), 13.0, arc, 3))
    cases.append(("(52,70)", integer_image((52, 70), 7), 13.0, 12, 3))
    cases.append(("(41,257)", integer_image((41, 257), 7), 13.0, 12, 3))
    cases.append(("(48,128) border 8 t 40", integer_image((48, 128), 3), 40.0, 12, 8))
    cases.append(("(30,40) smaller than the border", integer_image((30, 40), 5),
                  13.0, 12, 19))
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = torch.rand((203, 331), generator=g, device=dev) * 255.0
    cases.append(("(203,331) non-integer f32", rnd, 7.5, 12, 3))
    cases.append(("(203,331) non-integer f32 arc 9", rnd, 3.25, 9, 5))

    worst, all_equal = 0.0, True
    for name, img, thr, arc, border in cases:
        got = fused_fast.fast_nms_response(img, thr, arc, border)
        ref = fused_fast.fast_nms_response_reference(img, thr, arc, border)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        corners = int((ref > 0).sum())
        equal = torch.equal(got, ref)
        all_equal = all_equal and equal
        say(f"  kernel vs plain  {name:36s} corners {corners:6d}  "
            f"max_abs_err {err:g}  equal {equal}")
        if not equal:
            raise SystemExit(f"FAIL: fast_nms kernel disagrees with its plain "
                             f"version at {name}")
    for bad in (lambda: fused_fast.fast_nms_response(rnd, 7.5, 12, 2),
                lambda: fused_fast.fast_nms_response(rnd.double(), 7.5, 12, 3),
                lambda: fused_fast.fast_nms_response(rnd.T, 7.5, 12, 3)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAIL: the wrapper accepted an input the kernel does not take")
    return worst, all_equal


def phase_semantics(dev) -> None:
    """Tie orders the port relies on, and CPU/GPU agreement of the front-end
    on a small 8-bit input (where every level-0/1 pixel is exact in f32)."""
    import torch
    from jetracer_orbslam2_torch.config import FrontendConfig
    from jetracer_orbslam2_torch.io.synthetic import generate_sequence
    from jetracer_orbslam2_torch.models.frontend import frontend_gray_depth
    from jetracer_orbslam2_torch.utils.ties import first_argmax, first_argmin

    flat = torch.zeros(4096, device=dev)
    order = torch.sort(flat, descending=True, stable=True).indices
    if not torch.equal(order, torch.arange(4096, device=dev)):
        raise SystemExit("FAIL: stable descending sort does not keep index order")
    x = torch.zeros((64, 300), device=dev)
    if int(first_argmax(x, 1)[1].max()) != 0 or int(first_argmin(x, 0)[1].max()) != 0:
        raise SystemExit("FAIL: first_argmax/first_argmin do not take the first index")

    seq = generate_sequence(2, (120, 160), device=dev)
    gray = torch.round(seq.gray)
    cfg = FrontendConfig(height=120, width=160, num_levels=2, max_keypoints=256)
    on_gpu = frontend_gray_depth(gray[1], seq.depth[1], seq.intrinsics, cfg)
    on_cpu = frontend_gray_depth(gray[1], seq.depth[1], seq.intrinsics, cfg,
                                 device="cpu")
    for name in ("xy", "level", "score", "valid", "has_point"):
        if not torch.equal(getattr(on_gpu, name).cpu(), getattr(on_cpu, name)):
            raise SystemExit(f"FAIL: front-end field {name} differs between GPU and CPU")
    valid = on_cpu.valid
    same = (on_gpu.desc.cpu() == on_cpu.desc).all(-1)[valid]
    frac = float(same.float().mean())
    say(f"  front-end GPU vs CPU at 120x160: keypoints identical "
        f"({int(valid.sum())} valid), descriptors identical on {frac:.4f}")
    if frac < 0.99:
        raise SystemExit("FAIL: descriptors differ between GPU and CPU")


def open_source(n_frames: int, dev):
    """Render the sequence on the card through the CLI's own source function;
    returns (parsed args, source tuple, pyramid levels of frame 0)."""
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.ops import preprocess

    argv = ["--synthetic", str(n_frames), "--mode", "odometry", "--json"]
    args = run.build_argparser().parse_args(argv)
    t0 = time.perf_counter()
    source = run._open_source(args, dev)
    torch.cuda.synchronize()
    frames, n, hw = source[:3]
    say(f"  rendered {n} frames of {hw[1]}x{hw[0]} on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    gray0 = next(iter(frames()))[0]
    levels = preprocess.build_pyramid(
        preprocess.gaussian_blur_3x3(gray0), args.levels)
    return argv, args, source, levels


def phase_main_path(argv, args, source, dev):
    """Whole-sequence odometry through the CLI's functions; returns the
    report and the kernel's launch count on that run."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.ops import fused_fast

    frames, n, hw, intr, gt = source
    fused_fast.fast_nms_response.launches = 0
    report, poses = run._run_odometry(args, frames, n, hw, intr, dev)
    launches = fused_fast.fast_nms_response.launches
    run._accuracy(report, poses, gt, n)
    say("  main path (cold): " + json.dumps(report))
    if not np.isfinite(poses).all() or poses.shape != (n, 4, 4):
        raise SystemExit("FAIL: poses are not finite (N, 4, 4)")
    if launches != args.levels * n:
        raise SystemExit(f"FAIL: fast_nms launches {launches} != {args.levels} * {n}")
    if not report["ate_rmse_m"] < 0.10:
        raise SystemExit(f"FAIL: ATE RMSE {report['ate_rmse_m']} m >= 0.10 m")
    if not report["tracked_frac"] >= 0.95:
        raise SystemExit(f"FAIL: tracked_frac {report['tracked_frac']} < 0.95")

    # constant-memory streaming on the same frames: the same poses
    chunk_args = run.build_argparser().parse_args(argv + ["--chunked", "32"])
    c_report, c_poses = run._run_odometry(chunk_args, frames, n, hw, intr, dev)
    say("  main path (--chunked 32): " + json.dumps(c_report))
    if not np.array_equal(c_poses, poses):
        raise SystemExit("FAIL: --chunked 32 poses differ from the whole scan "
                         f"(max abs diff {np.abs(c_poses - poses).max():g})")

    # warm run, timed on the device's clock with one final synchronisation
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    w_report, w_poses = run._run_odometry(args, frames, n, hw, intr, dev)
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop)
    if not np.array_equal(w_poses, poses):
        raise SystemExit("FAIL: a second run with the same seed gave other poses")
    report["warm_ms_per_frame"] = ms / n
    report["warm_fps"] = n / (ms / 1e3)
    say(f"  main path (warm): {n} frames in {ms:.1f} ms -> "
        f"{report['warm_fps']:.1f} frames/s ({ms / n:.3f} ms/frame, "
        f"host-clock fps {w_report['fps']})")
    return report, launches


def phase_kernel_times(levels) -> dict:
    """Per level shape: kernel ms, plain ms, bound ms; and their means over
    the four launches a frame makes."""
    from jetracer_orbslam2_torch.ops import fused_fast

    shapes = []
    for lvl in levels:
        img = lvl.contiguous()
        n_bytes, n_ops = fast_nms_work(img, FAST_THRESHOLD, FAST_BORDER)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        before = fused_fast.fast_nms_response.launches
        ms = time_launches(lambda: fused_fast.fast_nms_response(
            img, FAST_THRESHOLD, FAST_ARC, FAST_BORDER), reps=20, batch=20)
        assert fused_fast.fast_nms_response.launches > before
        plain_ms = time_launches(
            lambda: fused_fast.fast_nms_response_reference(
                img, FAST_THRESHOLD, FAST_ARC, FAST_BORDER), reps=20, batch=2)
        row = {"shape": list(img.shape), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": n_bytes, "operations": n_ops}
        shapes.append(row)
        say(f"  fast_nms {tuple(img.shape)}: kernel {ms:.5f} ms on the card, "
            f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}: {n_bytes} B, {n_ops} f32 ops)")
    k = len(shapes)
    bytes_ms = sum(s["bytes"] for s in shapes) / HBM_BYTES_PER_S * 1e3 / k
    ops_ms = sum(s["operations"] for s in shapes) / F32_OPS_PER_S * 1e3 / k
    return {
        # means per launch over the launches one frame makes (one per level)
        "ms": sum(s["ms"] for s in shapes) / k,
        "plain_ms": sum(s["plain_ms"] for s in shapes) / k,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "shapes": shapes,
    }


def main() -> int:
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # the port under test; absent in a directory that holds only this script
    import jetracer_orbslam2_torch
    from jetracer_orbslam2_torch.ops import fused_fast
    from jetracer_orbslam2_torch.utils import cuda_build
    from jetracer_orbslam2_torch.utils.device import resolve_device
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    say("[1/6] device")
    card = card_line()
    say(card)
    dev = resolve_device(None)
    set_exact_f32()
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, port {jetracer_orbslam2_torch.__version__}")

    say("[2/6] build")
    fused_fast._launcher()
    info = cuda_build.build_info["fast_nms"]
    say(f"  nvcc built csrc/fast_nms.cu in {info['seconds']:.2f} s -> "
        f"{cuda_build.library_path('fast_nms').name}")
    for line in info["log"].splitlines():
        say("    " + line)

    with torch.no_grad():
        say("[3/6] kernel vs its plain version (torch.equal)")
        argv_run, args, source, levels = open_source(N_FRAMES, dev)
        max_err, all_equal = phase_kernel_checks(levels)

        say("[4/6] device semantics")
        phase_semantics(dev)

        say(f"[5/6] main path: {N_FRAMES} frames of 640x480, 4 levels, K=1024")
        report, launches = phase_main_path(argv_run, args, source, dev)

        say("[6/6] kernel times (CUDA events around a replayed CUDA graph of 20 "
            "launches, median of 20; the image is L2-warm, as the front-end "
            "leaves it)")
        times = phase_kernel_times(levels)
    torch.cuda.synchronize()

    kernels = {"kernels": [{
        "name": "fast_nms_response",
        "route": "cuda",
        "source": "jetracer_orbslam2_torch/csrc/fast_nms.cu",
        "replaces": "jetracer_orbslam2_tpu/ops/pallas_fast.py:162",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
        "exact_match": all_equal,
        "numbers_are": "means per launch over the four level shapes of a frame",
        "shapes": times["shapes"],
    }]}
    say(json.dumps({"main_path": report, "card": card,
                    "seconds": round(time.perf_counter() - t_start, 1)}))
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
