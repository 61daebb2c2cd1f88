#!/usr/bin/env python3
"""The gated lap through the JAX package and through the PyTorch port, both on
the CPU, on the same frames.

    JAX_PLATFORMS=cpu python3 scripts/compare_lap_cpu.py [--seeds 0 1 2]
        [--frontend jax|port]

Renders the lap of the JAX package's SLAM gate (126 frames of 240x180, one lap
of 110, 3 levels, 512 keypoints, match window 16 px, depth noise 2 % z^2 from
numpy's RandomState(0)) with the JAX generator, extracts the features once with
the JAX front-end and feeds them to both packages' host loop `Slam`, once as
configured and once with the retrieval gate shut (`min_sim` 2, so that no loop
can close).  Prints one JSON line per run: keyframes, loops, tracked fraction,
ATE and the mean gap between the revisit (frames 110..125) and the frames it
revisits (0..15).  The two packages draw different RANSAC samples, so the port
is run once per `--seeds` value; the spread says how much of the lap's ATE is
the draw, and the gate-shut runs say what the closure did to it.  With
`--frontend port` the port's `Slam` extracts its own features from the same
frames (its own front-end, as on the card) instead of taking the JAX
package's.  Needs JAX and torch; no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2],
                    help="seeds of the port's RANSAC generator, one run each")
    ap.add_argument("--frontend", choices=("jax", "port"), default="jax",
                    help="whose front-end feeds the port's Slam")
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    import numpy as np

    from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
    from jetracer_orbslam2_tpu.config import LoopClosureConfig as JLoopClosureConfig
    from jetracer_orbslam2_tpu.config import SystemConfig as JSystemConfig
    from jetracer_orbslam2_tpu.config import TrackingConfig as JTrackingConfig
    from jetracer_orbslam2_tpu.evaluation import ate
    from jetracer_orbslam2_tpu.io.synthetic import generate_lap_sequence
    from jetracer_orbslam2_tpu.models.slam import Slam as JSlam

    from jetracer_orbslam2_torch import convert
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, LoopClosureConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.models.slam import Slam

    h, w, lap, n = 180, 240, 110, 126
    front = dict(height=h, width=w, num_levels=3, max_keypoints=512)
    jcfg = JSystemConfig(frontend=JFrontendConfig(**front),
                         tracking=JTrackingConfig(match_window=16.0))
    tcfg = SystemConfig(frontend=FrontendConfig(**front),
                        tracking=TrackingConfig(match_window=16.0))
    seq = generate_lap_sequence(n_frames=n, shape=(h, w), lap_frames=lap)
    depth = np.asarray(seq.depth)
    noisy = jnp.asarray(depth * (1.0 + 0.02 * depth * np.random.RandomState(0)
                                 .randn(*depth.shape).astype(np.float32)))

    def report(name, out, **extra):
        rmse = float(ate(jnp.asarray(out.poses), seq.poses).rmse)
        gap = np.linalg.norm(out.poses[lap:, :3, 3] - out.poses[:n - lap, :3, 3], axis=1)
        print(json.dumps({
            "package": name, **extra, "device": "cpu",
            "keyframes": out.num_keyframes, "loops": out.num_loops,
            "tracked_frac": float(np.mean(out.tracked)), "ate_rmse_m": rmse,
            "revisit_gap_mean_m": float(gap.mean()),
        }), flush=True)

    feats = None
    for gate, jc in (("as configured", jcfg),
                     ("shut", jcfg.replace(loop=JLoopClosureConfig(min_sim=2.0)))):
        jslam = JSlam(jc, seq.intrinsics)
        if feats is None:
            feats = [jslam.features(seq.gray[i], noisy[i]) for i in range(n)]
        for f in feats:
            jslam.process_features(f)
        report("jetracer_orbslam2_tpu", jslam.result(), loop_gate=gate)

    feats_np = [{name: np.asarray(getattr(f, name)) for name in f._fields}
                for f in feats]
    gray, noisy_np = np.asarray(seq.gray), np.asarray(noisy)
    for seed in args.seeds:
        for gate, tc in (("as configured", tcfg),
                         ("shut", tcfg.replace(loop=LoopClosureConfig(min_sim=2.0)))):
            slam = Slam(tc, np.asarray(seq.intrinsics), seed=seed, device="cpu")
            for i, f in enumerate(feats_np):
                if args.frontend == "port":
                    slam.process_frame(gray[i], noisy_np[i])
                else:
                    slam.process_features(convert.features_from_numpy(f, "cpu"))
            report("jetracer_orbslam2_torch", slam.result(), seed=seed,
                   loop_gate=gate, frontend=args.frontend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
