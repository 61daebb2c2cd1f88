#!/usr/bin/env python3
"""The stereo SLAM path through the JAX package and through the PyTorch port,
both on the CPU, on the same frames.

    JAX_PLATFORMS=cpu python3 scripts/compare_stereo_cpu.py [--sequences arc lap]
        [--packages jax torch] [--textures port|jax]

Renders the stereo workload of `chip_smoke.py` phase 18 (the JAX package's
`bench.py` stereo rows: 120 frames of 640x480, baseline 0.11 m; an open arc,
and a lap of 105 frames with its overshoot) with the PORT's generator on the
CPU, so that the numbers read here are the ones phase 18's frames give
(`--textures jax`: with the JAX generator's textures instead).  Both
packages then run their stereo `slam_scan` over the same left/right stacks
with `FrontendConfig(fast_min_threshold=7.0)` (4 levels, 1,024 keypoints),
`TrackingConfig(max_depth=80.0)` and `StereoConfig(baseline=0.11)` (the
port's RANSAC seed 0, as phase 18 draws).  Prints one JSON line per
(package, sequence): ATE RMSE, tracked fraction, loops, keyframes and wall
seconds.  `bench.py` gates these runs at 15 cm (arc) and
21 cm (lap, tracked >= 0.95); those bars are readings of another generator's
textures on another machine, which is what this script checks.  Needs JAX and
torch; no GPU.  Takes several minutes and a few GB of memory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPE = (480, 640)
FRAMES = 120
BASELINE = 0.11
LAP_FRAMES = 105


def _jax_textures():
    """The textures the JAX package's stereo generators draw (seed 0)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jetracer_orbslam2_tpu.io import synthetic

    keys = jax.random.split(jax.random.PRNGKey(0), len(synthetic._PLANES))
    return np.asarray(jnp.stack([synthetic.make_texture(k) for k in keys]))


def _render(kind: str, textures=None):
    from jetracer_orbslam2_torch.io import synthetic

    if kind == "arc":
        return synthetic.generate_stereo_sequence(
            n_frames=FRAMES, shape=SHAPE, baseline=BASELINE, textures=textures,
            device="cpu")
    return synthetic.generate_stereo_lap_sequence(
        n_frames=FRAMES, shape=SHAPE, lap_frames=LAP_FRAMES, baseline=BASELINE,
        textures=textures, device="cpu")


def _run_jax(left, right, intr):
    import jax.numpy as jnp
    import numpy as np

    from jetracer_orbslam2_tpu.config import (
        FrontendConfig, StereoConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_tpu.models import slam_scan as ss

    cfg = SystemConfig(
        frontend=FrontendConfig(height=SHAPE[0], width=SHAPE[1],
                                fast_min_threshold=7.0),
        tracking=TrackingConfig(max_depth=80.0),
        stereo=StereoConfig(baseline=BASELINE))
    st = ss.init_scan_state(jnp.asarray(left[0]), jnp.asarray(right[0]),
                            jnp.asarray(intr), cfg)
    final, out = ss.slam_scan(st, jnp.asarray(left[1:]), jnp.asarray(right[1:]),
                              jnp.asarray(intr), cfg)
    poses = np.concatenate([np.asarray(final.m.kf_pose)[:1],
                            ss.compose_trajectory(final, out)])
    return (poses, np.asarray(out.tracked), int(final.num_loops),
            int(final.m.num_kf))


def _run_torch(left, right, intr):
    import numpy as np

    from jetracer_orbslam2_torch.config import (
        FrontendConfig, StereoConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.models import slam_scan as ss

    cfg = SystemConfig(
        frontend=FrontendConfig(height=SHAPE[0], width=SHAPE[1],
                                fast_min_threshold=7.0),
        tracking=TrackingConfig(max_depth=80.0),
        stereo=StereoConfig(baseline=BASELINE))
    st = ss.init_scan_state(left[0], right[0], intr, cfg, device="cpu")
    final, out = ss.slam_scan(st, left[1:], right[1:], intr, cfg)
    poses = np.concatenate([final.m.kf_pose[:1].numpy(),
                            ss.compose_trajectory(final, out)])
    return poses, out.tracked.numpy(), int(final.num_loops), int(final.m.num_kf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequences", nargs="+", default=["arc", "lap"],
                    choices=("arc", "lap"))
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"],
                    choices=("jax", "torch"))
    ap.add_argument("--textures", choices=("port", "jax"), default="port",
                    help="jax: render with the JAX generator's textures "
                         "(the frames bench.py's bars were read on)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from jetracer_orbslam2_torch.evaluation import ate

    textures = _jax_textures() if args.textures == "jax" else None
    for kind in args.sequences:
        t0 = time.perf_counter()
        seq = _render(kind, textures)
        left, right = seq.left.numpy(), seq.right.numpy()
        intr = seq.intrinsics.numpy()
        print(json.dumps({"rendered": kind, "frames": FRAMES,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
        for pkg in args.packages:
            t0 = time.perf_counter()
            if pkg == "jax":
                poses, tracked, loops, kf = _run_jax(left, right, intr)
            else:
                poses, tracked, loops, kf = _run_torch(left, right, intr)
            rmse = float(ate(torch.from_numpy(poses.astype(np.float32)),
                             seq.poses).rmse)
            print(json.dumps({
                "package": ("jetracer_orbslam2_tpu" if pkg == "jax"
                            else "jetracer_orbslam2_torch"),
                "sequence": kind, "textures": args.textures, "device": "cpu",
                "frames": FRAMES,
                "ate_rmse_m": rmse, "tracked_frac": float(np.mean(tracked)),
                "loops": loops, "keyframes": kf,
                "seconds": round(time.perf_counter() - t0, 1),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
