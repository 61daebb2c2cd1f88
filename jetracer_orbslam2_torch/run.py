"""CLI entry of the port: run SLAM or odometry on a dataset or a synthetic
sequence.

    python -m jetracer_orbslam2_torch.run --dataset tests/fixtures/tum_tiny
    python -m jetracer_orbslam2_torch.run --dataset tests/fixtures/euroc_tiny/mav0 --chunked 4
    python -m jetracer_orbslam2_torch.run --synthetic 100
    python -m jetracer_orbslam2_torch.run --synthetic 100 --mode odometry
    python -m jetracer_orbslam2_torch.run --synthetic 8 --device cpu
    python -m jetracer_orbslam2_torch.run --dataset DIR --telemetry 9002 --checkpoint ck
    python -m jetracer_orbslam2_torch.run --dataset DIR --resume ck
    python -m jetracer_orbslam2_torch.run --synthetic 100 --mesh 1
    python -m torch.distributed.run --nproc-per-node 4 -m jetracer_orbslam2_torch.run \
        --synthetic 100 --mesh 4 --distributed

Counterpart of `jetracer_orbslam2_tpu/run.py`.  The source is `--dataset DIR`
(TUM RGB-D, EuRoC `mav0/` or KITTI odometry, sniffed by `open_dataset`) or
`--synthetic N` frames.  `--mode slam` (the default) runs the full system
through the host loop `Slam`, or through `ChunkedSlam` with `--chunked C`;
a stereo dataset (baseline > 0) runs the stereo front-end, and its IMU
packets feed the attitude filter.  `--mode odometry` (whole-sequence or
`--chunked C`) needs depth frames.  Runs on `cuda:0` unless `--device cpu` is
given.

The host loop runs as the JAX CLI's does: a `FramePipeline` of two worker
threads decodes frames ahead of it (to pinned host memory; every CUDA call
stays on the main thread), a `Watchdog` counts stalls, `--telemetry PORT`
streams BSON frames over a WebSocket to `viewer/index.html`
(`--telemetry-no-image` leaves the JPEG out), `--checkpoint DIR` saves the
final map and `--resume DIR` starts from a saved one (either package's).
`--mode odometry` and `--chunked` ignore these flags, as the JAX CLI does.

`--mesh N` runs every windowed BA of the SLAM system landmark-sharded over
N ranks (`parallel/ba_sharded.py`): one process per rank, each running the
whole system on its own card in lockstep, the reduced camera system
all-reduced once an LM iteration.  `--mesh 1` builds a one-rank group on the
run's device; more ranks need a joined group: start the processes with
`python -m torch.distributed.run --nproc-per-node N` and pass
`--distributed`, which joins the group from its variables (and, with none
set, logs the single-process fallback and runs on).  A distributed run's
device is `cuda:LOCAL_RANK`.  With `--chunked C` the report's `scan_route`
names the scan's route: `frame_graph`, or `host_branch` for a mesh on the
card that K8 cannot serve (more than 8 ranks, several hosts).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Callable, NamedTuple, Optional

log = logging.getLogger("jetracer_orbslam2_torch")

_NO_CAL = {"dist": None, "dist_model": "brown_conrady", "dist_r": None,
           "rect_l": None, "rect_r": None, "intrinsics_r": None,
           "depth_intrinsics": None, "depth_dist": None,
           "T_color_depth": None}


def build_argparser():
    p = argparse.ArgumentParser(description="PyTorch/CUDA SLAM runner")
    p.add_argument("--dataset", help="TUM / EuRoC mav0 / KITTI sequence dir")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic frames instead of a dataset")
    p.add_argument("--mode", choices=("odometry", "slam"), default="slam",
                   help="slam = full system (map/BA/loops); odometry = "
                        "whole-sequence on-device frame loop (RGB-D)")
    p.add_argument("--chunked", type=int, default=0, metavar="C",
                   help="processing over C-frame chunks: with --mode slam "
                        "the full system through ChunkedSlam (RGB-D or "
                        "stereo), with --mode odometry constant-memory "
                        "streaming")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--checkpoint", help="directory to save the final map")
    p.add_argument("--resume", help="checkpoint directory to start from")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the map backend's BA over an N-rank mesh "
                        "(N > 1: under torch.distributed.run, with "
                        "--distributed)")
    p.add_argument("--distributed", action="store_true",
                   help="join a process group first (MASTER_ADDR / "
                        "MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK, as "
                        "torch.distributed.run sets them)")
    p.add_argument("--telemetry", type=int, default=0, metavar="PORT",
                   help="serve live BSON telemetry on ws://0.0.0.0:PORT "
                        "(open viewer/index.html to watch; 0 = off)")
    p.add_argument("--telemetry-no-image", action="store_true",
                   help="omit the JPEG image from telemetry frames")
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
                   help="print one JSON result line (for tooling), with the "
                        "run's spans by name (`spans`)")
    return p


class Source(NamedTuple):
    """A frame source.  `load(i)` returns frame i as (gray, depth, right,
    imu_packet): tensors (None where the source has none) and a tuple of
    numpy arrays or None.  A dataset's frames are decoded to host tensors,
    pinned when the device is a CUDA one; a synthetic sequence's already lie
    on the device.  `load` queues no work on the card (it only pins host
    memory), so worker threads may run it.
    `gt` is the ground truth as numpy or None, `cal` the camera calibration
    the loader found (the keys of `_NO_CAL`)."""
    load: Callable
    n: int
    hw: tuple
    intr: "torch.Tensor"
    baseline: float
    gt: Optional["np.ndarray"]
    cal: dict
    device: "torch.device"

    def frames(self):
        """Frames 0..n-1 on the device, loaded on the calling thread."""
        for i in range(self.n):
            yield to_device(self.load(i), self.device)


def to_device(frame, device):
    """A frame from `Source.load` on `device`.  Host tensors are pinned, so
    their copies are queued behind the card's work without a host wait; the
    caching host allocator keeps each pinned block until its copy is done."""
    g, d, r, pk = frame

    def up(x):
        return None if x is None else x.to(device, non_blocking=True)
    return up(g), up(d), up(r), pk


def _open_source(args, device) -> Source:
    """Resolve the frame source (`--synthetic N` or `--dataset DIR`)."""
    import numpy as np
    import torch

    if args.synthetic:
        from jetracer_orbslam2_torch.io.synthetic import generate_sequence

        n = args.synthetic
        seq = generate_sequence(n_frames=n, shape=(480, 640), device=device)
        gt = seq.poses.cpu().numpy()

        def load(i):
            return seq.gray[i], seq.depth[i], None, None

        return Source(load, n, (480, 640), seq.intrinsics, 0.0, gt,
                      dict(_NO_CAL), device)

    from jetracer_orbslam2_torch.io.datasets import open_dataset

    ds = open_dataset(args.dataset)
    n = len(ds) if not args.max_frames else min(len(ds), args.max_frames)
    gt = ds.groundtruth[:n] if ds.groundtruth is not None else None
    # per-frame IMU packets when the dataset ships an IMU (EuRoC imu0)
    imu_pk = getattr(ds, "imu_packets", lambda: None)()
    cal = {k: getattr(ds, k, v) for k, v in _NO_CAL.items()}
    pin = device.type == "cuda"

    def host(a):
        if a is None:
            return None
        t = torch.from_numpy(a)
        return t.pin_memory() if pin else t

    def load(i):
        fr = ds.frame(i)
        pk = None if imu_pk is None else tuple(p[i] for p in imu_pk)
        return host(fr.gray), host(fr.depth), host(fr.right), pk

    intr = torch.from_numpy(np.asarray(ds.intrinsics, np.float32)).to(device)
    return Source(load, n, ds.frame(0).gray.shape, intr, float(ds.baseline),
                  gt, cal, device)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _frontend_cfg(args, hw, cal):
    from jetracer_orbslam2_torch.config import FrontendConfig

    h, w = hw
    return FrontendConfig(
        height=h, width=w, num_levels=args.levels,
        max_keypoints=args.max_keypoints,
        fast_min_threshold=args.fast_min_threshold,
        dist=cal["dist"], dist_model=cal["dist_model"],
        depth_intrinsics=cal["depth_intrinsics"],
        depth_dist=cal["depth_dist"], T_color_depth=cal["T_color_depth"])


def _tup(v):
    return None if v is None else tuple(float(x) for x in v)


_NEEDS_DEPTH = ("odometry mode needs depth frames (RGB-D dataset or "
                "--synthetic); use --mode slam for stereo datasets")


def _run_odometry(args, src: Source, device):
    """Whole-sequence on-device odometry (or constant-memory chunks).
    Returns None when the source has no depth."""
    import numpy as np
    import torch

    from jetracer_orbslam2_torch.config import TrackingConfig
    from jetracer_orbslam2_torch.models.odometry import (
        ChunkedOdometry, init_state, odometry_scan)

    n, intr = src.n, src.intr
    fcfg = _frontend_cfg(args, src.hw, src.cal)
    tcfg = TrackingConfig()
    if src.baseline > 0.0:
        log.error(_NEEDS_DEPTH)
        return None

    if args.chunked:
        ch = ChunkedOdometry(intr, fcfg, tcfg, chunk_size=args.chunked,
                             device=device)
        _sync(device)
        t0 = time.perf_counter()
        count = 0
        for g, d, _, _ in src.frames():
            if d is None:
                log.error(_NEEDS_DEPTH)
                return None
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
            "counters": {
                "staging_waits": ch.staging_waits,
                "frames_replayed_on_arrival": ch.frames_replayed_on_arrival},
        }, poses

    gray, depth = [], []
    for g, d, _, _ in src.frames():
        if d is None:
            log.error(_NEEDS_DEPTH)
            return None
        gray.append(g)
        depth.append(d)
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


def _run_slam(args, src: Source, device, mesh=None):
    """The full system: the host loop `Slam` behind the runtime, or
    `ChunkedSlam` over `--chunked C` frames at a time; stereo when the source
    has a baseline.  Returns None when a frame has neither depth nor a right
    image."""
    import numpy as np

    from jetracer_orbslam2_torch.config import (
        StereoConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.models.slam_scan import ChunkedSlam

    fcfg = _frontend_cfg(args, src.hw, src.cal)
    is_stereo = src.baseline > 0.0
    cal = src.cal

    if args.chunked:
        stereo_cfg, tcfg = None, TrackingConfig()
        if is_stereo:
            # each chunk's frames are (left, right) pairs, and the stereo
            # front-end runs inside the scan step (models/slam_scan._features)
            stereo_cfg = StereoConfig(
                baseline=float(src.baseline),
                dist_r=_tup(cal["dist_r"]), rect_l=_tup(cal["rect_l"]),
                rect_r=_tup(cal["rect_r"]),
                intrinsics_r=_tup(cal["intrinsics_r"]))
            tcfg = TrackingConfig(max_depth=80.0)
        cfg = SystemConfig(frontend=fcfg, tracking=tcfg, stereo=stereo_cfg)
        ch = ChunkedSlam(cfg, src.intr, chunk_size=args.chunked, mesh=mesh,
                         device=device)
        _sync(device)
        t0 = time.perf_counter()
        count = 0
        for g, d, right, pk in src.frames():
            second = right if is_stereo else d
            if second is None:
                log.error("--chunked needs RGB-D or stereo frames")
                return None
            ch.process_frame(g, second, imu_packet=pk)
            count += 1
        ch.flush()
        poses = ch.result()
        wall = time.perf_counter() - t0
        report = {
            "mode": f"slam-chunked{args.chunked}",
            "stereo": is_stereo,
            "frames": count,
            "fps": round(count / wall, 2),
            "tracked_frac": float(np.mean(ch.tracked())),
            "keyframes": int(ch.state.m.num_kf),
            "landmarks": int(ch.state.m.num_lm),
            "loops": int(ch.state.num_loops),
            "relocs": int(ch.state.num_relocs),
            "scan_route": ch.route,
        }
        if mesh is not None:
            report["mesh_devices"] = mesh.size
            report["ba_edges_dropped"] = int(ch.state.ba_edges_dropped)
        return report, poses
    return _run_host_loop(args, src, SystemConfig(frontend=fcfg), device, mesh)


def _run_host_loop(args, src: Source, cfg, device, mesh=None):
    """`Slam` frame by frame, as the JAX CLI runs it: frames decoded ahead by
    a `FramePipeline` (two workers, blocking, in order), a `Watchdog` beat a
    frame, a telemetry frame after each processed frame, `--resume` /
    `--checkpoint` around the run; ctrl-C reports the frames done so far."""
    import numpy as np

    from jetracer_orbslam2_torch.models.slam import Slam
    from jetracer_orbslam2_torch.models.stereo import frontend_stereo
    from jetracer_orbslam2_torch.runtime.liveness import Watchdog
    from jetracer_orbslam2_torch.runtime.pipeline import FramePipeline

    is_stereo = src.baseline > 0.0
    cal = src.cal
    slam = Slam(cfg, src.intr, mesh=mesh, device=device)
    if args.resume:
        from jetracer_orbslam2_torch.runtime.checkpoint import load_checkpoint

        slam.m, _ = load_checkpoint(args.resume, device=device)
        log.info("resumed map: %d keyframes, %d landmarks",
                 int(slam.m.num_kf), int(slam.m.num_lm))

    publisher = None
    server = None
    if args.telemetry:
        from jetracer_orbslam2_torch.runtime.telemetry import (
            TelemetryPublisher, WebSocketServer)

        server = WebSocketServer(port=args.telemetry, host="0.0.0.0",
                                 rate_bytes_per_s=cfg.runtime
                                 .telemetry_rate_bytes).start()
        publisher = TelemetryPublisher(
            server, send_image=not args.telemetry_no_image)
        log.info("telemetry on ws://0.0.0.0:%d (viewer/index.html)",
                 server.port)

    t_max = cfg.tracking.max_depth
    # liveness probe (reference PingPong.cpp:27-81): flags a wedged device
    # dispatch or a stuck source; generous timeout, as the first keyframe
    # may build the BA kernels
    watchdog = Watchdog(timeout_s=180.0).start()
    pipe = FramePipeline(range(src.n), transform=src.load, capacity=8,
                         num_workers=2)
    _sync(device)
    t0 = time.perf_counter()
    count = 0
    try:
        for frame in pipe:
            watchdog.beat()
            g, d, right, pk = to_device(frame, device)
            if is_stereo:
                feats = frontend_stereo(
                    g, right, src.intr, float(src.baseline), cfg.frontend,
                    max_depth=t_max if t_max > 8 else 80.0,
                    dist_r=cal["dist_r"], rect_l=cal["rect_l"],
                    rect_r=cal["rect_r"], intrinsics_r=cal["intrinsics_r"],
                    device=device)
            elif d is None:
                log.error("slam mode needs depth or stereo frames")
                return None
            else:
                feats = slam.features(g, d)
            slam.process_features(feats, imu_packet=pk)
            if publisher is not None:
                # the frame's grey image as loaded: host memory for a
                # dataset, so only the keypoints cross from the card
                publisher.publish(
                    frame[0], feats.xy, feats.valid,
                    euler_deg=np.degrees(slam.attitude),
                    pose=slam.trajectory[-1])
            count += 1
            if count % 50 == 0:
                log.info("[%d/%d] loops=%d", count, src.n, slam.num_loops)
    except KeyboardInterrupt:
        log.warning("interrupted: reporting partial run")
    finally:
        pipe.close()
        watchdog.close()
        if server is not None:
            server.close()
    out = slam.result()
    wall = time.perf_counter() - t0
    report = {
        "mode": "slam",
        "stereo": is_stereo,
        "frames": count,
        "fps": round(count / wall, 2),
        "tracked_frac": float(np.mean(out.tracked)),
        "keyframes": out.num_keyframes,
        "landmarks": out.num_landmarks,
        "loops": out.num_loops,
        "relocs": out.num_relocs,
        "attitude_rad": [round(float(x), 4) for x in slam.attitude],
        "watchdog_stalls": watchdog.stalls,
    }
    if mesh is not None:
        report["mesh_devices"] = mesh.size
        report["ba_edges_dropped"] = slam.ba_edges_dropped
    if server is not None:
        report["telemetry_sent"] = server.sent_frames
        report["telemetry_dropped"] = server.dropped_frames
    if args.checkpoint:
        from jetracer_orbslam2_torch.runtime.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, slam.m, extra={"frames": count})
        report["checkpoint"] = args.checkpoint
    return report, out.poses


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

    if not args.synthetic and not args.dataset:
        print("need --dataset or --synthetic", file=sys.stderr)
        return 2

    import torch.distributed as dist

    from jetracer_orbslam2_torch.parallel import mesh as mesh_mod
    from jetracer_orbslam2_torch.utils.device import resolve_device
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    set_exact_f32()
    t_spans = time.perf_counter_ns()
    had_group = dist.is_initialized()
    mesh = None
    try:
        if args.distributed:
            multi = mesh_mod.init_distributed(device=args.device)
            log.info("distributed init: %s",
                     f"{dist.get_world_size()} ranks" if multi else
                     "single-process fallback")
        if dist.is_initialized():
            device = mesh_mod.rank_device(args.device)
        else:
            device = resolve_device(args.device)
        if args.mesh:
            world = dist.get_world_size() if dist.is_initialized() else 1
            if args.mesh != world:
                print(f"--mesh {args.mesh} needs a group of {args.mesh} "
                      f"processes (this one has {world}): run python -m "
                      f"torch.distributed.run --nproc-per-node {args.mesh} "
                      f"-m jetracer_orbslam2_torch.run ... --distributed",
                      file=sys.stderr)
                return 2
            mesh = mesh_mod.make_mesh(args.mesh, device=device)
            log.info("map backend sharded over %r", mesh)
        log.info("running on %s", device)

        src = _open_source(args, device)
        if args.mode == "odometry":
            res = _run_odometry(args, src, device)
        else:
            res = _run_slam(args, src, device, mesh)
    finally:
        if mesh is not None:
            mesh.close()        # its peer buffers; a group it made
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()
    if res is None:
        return 2
    report, poses = res
    report["device"] = str(device)
    _accuracy(report, poses, src.gt, min(report["frames"], len(poses)))
    if args.json:
        from jetracer_orbslam2_torch.utils.timing import RECORDER

        report["spans"] = RECORDER.summary(t_spans)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
