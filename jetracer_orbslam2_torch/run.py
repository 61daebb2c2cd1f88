"""CLI entry of the port: run SLAM or odometry on a synthetic sequence.

    python -m jetracer_orbslam2_torch.run --synthetic 100
    python -m jetracer_orbslam2_torch.run --synthetic 100 --chunked 8
    python -m jetracer_orbslam2_torch.run --synthetic 100 --mode odometry
    python -m jetracer_orbslam2_torch.run --synthetic 8 --device cpu

Counterpart of `jetracer_orbslam2_tpu/run.py` for the part of the system that
is ported: on `--synthetic N` frames, `--mode slam` (the default: the full
system through the host loop `Slam`, or through `ChunkedSlam` with
`--chunked C`) and `--mode odometry` (whole-sequence or `--chunked C`).
`--dataset`, `--mesh`, `--telemetry`, `--checkpoint` and `--resume` are not
ported yet and exit with code 2.  Runs on `cuda:0` unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

log = logging.getLogger("jetracer_orbslam2_torch")


def build_argparser():
    p = argparse.ArgumentParser(description="PyTorch/CUDA SLAM runner")
    p.add_argument("--dataset", help="dataset directory (not ported yet)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic frames")
    p.add_argument("--mode", choices=("odometry", "slam"), default="slam",
                   help="slam = full system (map/BA/loops); odometry = "
                        "whole-sequence on-device frame loop (RGB-D)")
    p.add_argument("--chunked", type=int, default=0, metavar="C",
                   help="processing over C-frame chunks: with --mode slam "
                        "the full system through ChunkedSlam, with --mode "
                        "odometry constant-memory streaming")
    for flag, meta in (("--mesh", "N"), ("--telemetry", "PORT"),
                       ("--checkpoint", "DIR"), ("--resume", "DIR")):
        p.add_argument(flag, metavar=meta, help="not ported yet")
    p.add_argument("--max-keypoints", type=int, default=1024)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--fast-min-threshold", type=float, default=0.0,
                   help="two-threshold adaptive FAST: cells empty at the "
                        "primary epsilon fall back to this lower one "
                        "(0 = off)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda:0 (an error without a "
                        "CUDA device). Pass 'cpu' to run on the CPU")
    p.add_argument("--log-level", default="info",
                   choices=("debug", "info", "warning", "error"))
    p.add_argument("--json", action="store_true",
                   help="print one JSON result line (for tooling)")
    return p


def _open_source(args, device):
    """Resolve the frame source.  Returns (frames() iterator of (gray,
    depth) device tensors, n, (h, w), intrinsics, gt poses as numpy)."""
    from jetracer_orbslam2_torch.io.synthetic import generate_sequence

    n = args.synthetic
    seq = generate_sequence(n_frames=n, shape=(480, 640), device=device)
    gt = seq.poses.cpu().numpy()

    def frames():
        for i in range(n):
            yield seq.gray[i], seq.depth[i]

    return frames, n, (480, 640), seq.intrinsics, gt


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_odometry(args, frames, n, hw, intr, device):
    """Whole-sequence on-device odometry (or constant-memory chunks)."""
    import numpy as np
    import torch

    from jetracer_orbslam2_torch.config import FrontendConfig, TrackingConfig
    from jetracer_orbslam2_torch.models.odometry import (
        ChunkedOdometry, init_state, odometry_scan)

    h, w = hw
    fcfg = FrontendConfig(height=h, width=w, num_levels=args.levels,
                          max_keypoints=args.max_keypoints,
                          fast_min_threshold=args.fast_min_threshold)
    tcfg = TrackingConfig()

    if args.chunked:
        ch = ChunkedOdometry(intr, fcfg, tcfg, chunk_size=args.chunked,
                             device=device)
        _sync(device)
        t0 = time.perf_counter()
        count = 0
        for g, d in frames():
            ch.process_frame(g, d)
            count += 1
        ch.flush()
        poses, ok = ch.result()
        wall = time.perf_counter() - t0
        return {
            "mode": f"odometry-chunked{args.chunked}",
            "frames": count,
            "fps": round(count / wall, 2),
            "tracked_frac": float(np.mean(ok)),
        }, poses

    gray, depth = zip(*frames())
    gray = torch.stack(gray)
    depth = torch.stack(depth)

    _sync(device)
    t0 = time.perf_counter()
    state0 = init_state(gray[0], depth[0], intr, fcfg, tcfg, device=device)
    _, poses_d, ok = odometry_scan(state0, gray[1:], depth[1:], intr, fcfg, tcfg)
    # one fetch for the whole scan (this is also the only synchronisation)
    poses = np.concatenate([np.eye(4, dtype=np.float32)[None],
                            poses_d.cpu().numpy()])
    ok = ok.cpu().numpy()
    wall = time.perf_counter() - t0
    return {
        "mode": "odometry",
        "frames": n,
        "fps": round(n / wall, 2),
        "tracked_frac": float(np.mean(ok)) if ok.size else 1.0,
    }, poses


def _run_slam(args, frames, n, hw, intr, device):
    """The full system: the host loop `Slam`, or `ChunkedSlam` over
    `--chunked C` frames at a time."""
    import numpy as np

    from jetracer_orbslam2_torch.config import FrontendConfig, SystemConfig
    from jetracer_orbslam2_torch.models.slam import Slam
    from jetracer_orbslam2_torch.models.slam_scan import ChunkedSlam

    h, w = hw
    cfg = SystemConfig(frontend=FrontendConfig(
        height=h, width=w, num_levels=args.levels,
        max_keypoints=args.max_keypoints,
        fast_min_threshold=args.fast_min_threshold))

    if args.chunked:
        ch = ChunkedSlam(cfg, intr, chunk_size=args.chunked, device=device)
        _sync(device)
        t0 = time.perf_counter()
        count = 0
        for g, d in frames():
            ch.process_frame(g, d)
            count += 1
        ch.flush()
        poses = ch.result()
        wall = time.perf_counter() - t0
        return {
            "mode": f"slam-chunked{args.chunked}",
            "frames": count,
            "fps": round(count / wall, 2),
            "tracked_frac": float(np.mean(ch.tracked())),
            "keyframes": int(ch.state.m.num_kf),
            "landmarks": int(ch.state.m.num_lm),
            "loops": int(ch.state.num_loops),
            "relocs": int(ch.state.num_relocs),
        }, poses

    slam = Slam(cfg, intr, device=device)
    _sync(device)
    t0 = time.perf_counter()
    count = 0
    for g, d in frames():
        slam.process_frame(g, d)
        count += 1
        if count % 50 == 0:
            log.info("[%d/%d] loops=%d", count, n, slam.num_loops)
    out = slam.result()
    wall = time.perf_counter() - t0
    return {
        "mode": "slam",
        "frames": count,
        "fps": round(count / wall, 2),
        "tracked_frac": float(np.mean(out.tracked)),
        "keyframes": out.num_keyframes,
        "landmarks": out.num_landmarks,
        "loops": out.num_loops,
        "relocs": out.num_relocs,
    }, out.poses


def _accuracy(report, poses, gt, count):
    """ATE + drift-per-meter (RPE, KITTI convention) next to each other."""
    import numpy as np
    import torch

    from jetracer_orbslam2_torch.evaluation import ate, rpe_drift

    if gt is None or count < 2:
        return
    e = torch.from_numpy(np.asarray(poses[:count], dtype=np.float32))
    g = torch.from_numpy(np.asarray(gt[:count], dtype=np.float32))
    report["ate_rmse_m"] = round(float(ate(e, g).rmse), 4)
    d = max(1, min(10, count - 1))
    t_drift, r_drift = rpe_drift(e, g, delta=d)
    report["rpe_drift_pct"] = round(float(t_drift) * 100.0, 3)
    report["rpe_rot_deg_per_m"] = round(float(np.degrees(float(r_drift))), 4)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr)

    for flag in ("dataset", "mesh", "telemetry", "checkpoint", "resume"):
        if getattr(args, flag):
            print(f"--{flag} is not ported yet in jetracer_orbslam2_torch; "
                  "use --synthetic N", file=sys.stderr)
            return 2
    if not args.synthetic:
        print("need --synthetic N", file=sys.stderr)
        return 2

    from jetracer_orbslam2_torch.utils.device import resolve_device
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    set_exact_f32()
    device = resolve_device(args.device)
    log.info("running on %s", device)

    frames, n, hw, intr, gt = _open_source(args, device)
    run = _run_odometry if args.mode == "odometry" else _run_slam
    report, poses = run(args, frames, n, hw, intr, device)
    report["device"] = str(device)
    _accuracy(report, poses, gt, min(n, len(poses)))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
