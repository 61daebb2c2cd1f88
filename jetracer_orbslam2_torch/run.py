"""CLI entry of the port: run RGB-D odometry on a synthetic sequence.

    python -m jetracer_orbslam2_torch.run --synthetic 100 --mode odometry
    python -m jetracer_orbslam2_torch.run --synthetic 100 --mode odometry --chunked 32
    python -m jetracer_orbslam2_torch.run --synthetic 8 --mode odometry --device cpu

Counterpart of `jetracer_orbslam2_tpu/run.py` for the part of the system that
is ported: `--mode odometry` on `--synthetic N` frames, whole-sequence or
`--chunked C`.  `--mode slam` and `--dataset` are not ported yet and exit
with code 2.  Runs on `cuda:0` unless `--device cpu` is given.
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
                   help="odometry = whole-sequence on-device frame loop "
                        "(RGB-D); slam = full system (not ported yet)")
    p.add_argument("--chunked", type=int, default=0, metavar="C",
                   help="constant-memory streaming over C-frame chunks "
                        "(one host sync per chunk)")
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

    if args.dataset:
        print("--dataset is not ported yet in jetracer_orbslam2_torch; "
              "use --synthetic N", file=sys.stderr)
        return 2
    if not args.synthetic:
        print("need --synthetic N", file=sys.stderr)
        return 2
    if args.mode != "odometry":
        print("--mode slam is not ported yet in jetracer_orbslam2_torch; "
              "use --mode odometry", file=sys.stderr)
        return 2

    from jetracer_orbslam2_torch.utils.device import resolve_device
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    set_exact_f32()
    device = resolve_device(args.device)
    log.info("running on %s", device)

    frames, n, hw, intr, gt = _open_source(args, device)
    report, poses = _run_odometry(args, frames, n, hw, intr, device)
    report["device"] = str(device)
    _accuracy(report, poses, gt, min(n, len(poses)))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
