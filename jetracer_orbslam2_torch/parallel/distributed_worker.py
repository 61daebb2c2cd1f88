"""One rank of a multi-process sharded bundle adjustment.

    python -m jetracer_orbslam2_torch.parallel.distributed_worker \\
        INIT_METHOD WORLD RANK [--device cpu|cuda|cuda:K] [--backend B] \\
        [--problem P,L,OBS] [--iters N] [--time REPS] [--save PATH] [--slam]

Counterpart of `scripts/distributed_ba_worker.py`.  Start WORLD copies, one
per RANK, with the same INIT_METHOD (`file:///path/store` or
`tcp://host:port`).  Each joins the group (`init_distributed`), builds the
same seeded problem (`make_synthetic_ba(4, 64, 4)` unless `--problem` says
otherwise), runs `sharded_bundle_adjust` with `BAConfig(iters=8)` (or
`--iters`) on its landmark block, and prints ONE JSON line: the pose
translations, the first and last cost, the world size, a digest of poses,
points and trace (ranks must agree bit for bit), and on a CUDA device the
K2 / K3 launches of the solve.  `--time REPS` adds `time_sharded_ba`'s ms
per LM iteration, `--save PATH` writes poses, points and trace as .npz.

`--slam` also runs the live system with the mesh (saving process start-ups):
`Slam`, `slam_scan` and `ChunkedSlam` over 14 synthetic frames of 120x160,
each rank in lockstep, and reports their keyframe poses and trajectories.

`--device cuda` is cuda:LOCAL_RANK (cuda:0 without it); `--backend` defaults
to NCCL on a CUDA device and gloo on the CPU.  NCCL refuses two ranks on one
card: run those over gloo.  The group times out after 5 minutes, so a rank
that leaves the lockstep fails the others instead of hanging them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

SLAM_FRAMES, SLAM_SHAPE = 14, (120, 160)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _slam_check(mesh) -> dict:
    """Slam, slam_scan and ChunkedSlam with the mesh over 14 frames of
    120x160 at the small map of the JAX package's sharded-SLAM tests."""
    import numpy as np

    from jetracer_orbslam2_torch.io.synthetic import generate_sequence
    from jetracer_orbslam2_torch.models import slam_scan as ss
    from jetracer_orbslam2_torch.models.slam import Slam

    dev = mesh.device
    seq = generate_sequence(n_frames=SLAM_FRAMES, shape=SLAM_SHAPE, device=dev)
    cfg = slam_config()

    slam = Slam(cfg, seq.intrinsics, mesh=mesh)
    for i in range(SLAM_FRAMES):
        slam.process_frame(seq.gray[i], seq.depth[i])
    out = slam.result()

    st = ss.init_scan_state(seq.gray[0], seq.depth[0], seq.intrinsics, cfg,
                            device=dev)
    final, scan = ss.slam_scan(st, seq.gray[1:], seq.depth[1:],
                               seq.intrinsics, cfg, mesh=mesh)

    ch = ss.ChunkedSlam(cfg, seq.intrinsics, chunk_size=4, mesh=mesh)
    for i in range(SLAM_FRAMES):
        ch.process_frame(seq.gray[i], seq.depth[i])
    ch.flush()
    chunked = ch.result()

    as_list = lambda a: np.asarray(  # noqa: E731
        a.cpu().numpy() if hasattr(a, "cpu") else a, np.float32).tolist()
    return {
        "slam": {"kf_pose": as_list(slam.m.kf_pose), "poses": as_list(out.poses),
                 "num_kf": out.num_keyframes,
                 "ba_edges_dropped": slam.ba_edges_dropped},
        "scan": {"kf_pose": as_list(final.m.kf_pose), "T_rel": as_list(scan.T_rel),
                 "num_kf": int(final.m.num_kf),
                 "ba_edges_dropped": int(final.ba_edges_dropped)},
        "chunked": {"kf_pose": as_list(ch.state.m.kf_pose),
                    "poses": as_list(chunked),
                    "num_kf": int(ch.state.m.num_kf),
                    "ba_edges_dropped": int(ch.state.ba_edges_dropped)},
    }


def slam_config():
    """The `--slam` check's configuration (the JAX package's sharded-SLAM
    tests): 120x160, 2 levels, K 256, a map of 16 keyframes and 2,048
    landmarks."""
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, MapConfig, SystemConfig)

    h, w = SLAM_SHAPE
    return SystemConfig(
        frontend=FrontendConfig(height=h, width=w, num_levels=2,
                                max_keypoints=256),
        map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                      kf_min_gap=2, kf_max_gap=4, window_size=4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("init_method")
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (= cuda:LOCAL_RANK) or cuda:K")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--problem", default="4,64,4", help="P,L,OBS_PER_LM")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--time", type=int, default=0, metavar="REPS")
    ap.add_argument("--save", default=None)
    ap.add_argument("--slam", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from jetracer_orbslam2_torch.config import BAConfig
    from jetracer_orbslam2_torch.ops import fused_ba
    from jetracer_orbslam2_torch.parallel.ba_sharded import (
        prepare_sharded_problem, sharded_bundle_adjust)
    from jetracer_orbslam2_torch.parallel.bench_ba import (
        make_synthetic_ba, time_sharded_ba)
    from jetracer_orbslam2_torch.parallel.mesh import (
        init_distributed, make_mesh, rank_device)

    dev = rank_device(None if args.device == "cuda" else args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(args.init_method, args.world, args.rank, args.backend,
                     device=dev)
    try:
        mesh = make_mesh(args.world, device=dev)
        P, L, k = (int(v) for v in args.problem.split(","))
        cfg = BAConfig(iters=args.iters)
        prob, intr = make_synthetic_ba(P, L, k, device=dev)
        sprob = prepare_sharded_problem(prob, args.world, device=dev)
        fused_ba.fused_normal_schur.launches = 0
        fused_ba.fused_backsub.launches = 0
        poses, points, trace = sharded_bundle_adjust(sprob, intr, cfg, mesh)
        tr = trace.cpu().numpy()
        out = {
            "rank": args.rank, "world_size": mesh.size,
            "backend": mesh.backend, "device": str(dev),
            "poses_t": poses[:, :3, 3].cpu().numpy().tolist(),
            "cost0": float(tr[0]), "cost_final": float(tr[-1]),
            "digest": _digest(poses, points, trace),
        }
        if dev.type == "cuda":
            out["launches"] = {
                "fused_normal_schur": fused_ba.fused_normal_schur.launches,
                "fused_backsub": fused_ba.fused_backsub.launches}
        if args.save:
            np.savez(args.save, poses=poses.cpu().numpy(),
                     points=points.cpu().numpy(), trace=tr)
        if args.time:
            out["timing"] = time_sharded_ba(prob, intr, args.world, cfg,
                                            reps=args.time, device=dev)
        if args.slam:
            out["slam"] = _slam_check(mesh)
            out["slam_digest"] = hashlib.sha256(
                json.dumps(out["slam"]).encode()).hexdigest()
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
