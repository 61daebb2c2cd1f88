"""Bundle-adjustment benchmark problem and one-device timing.

Counterpart of `jetracer_orbslam2_tpu/parallel/bench_ba.py`:

  * `make_synthetic_ba` builds the standard synthetic problem (P poses in a
    line, L landmarks in a box, `obs_per_lm` observations each).  It is numpy
    with `default_rng(seed)`, so the arrays are the JAX package's bit for bit.
  * `time_ba` times the full LM schedule of `bundle_adjust` on one device
    with one host fetch per run.

The mesh-size sweep of the JAX module (`measure_scaling`) waits for the
sharded solver.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from jetracer_orbslam2_torch.config import BAConfig
from jetracer_orbslam2_torch.models.backend.ba import BAProblem, bundle_adjust
from jetracer_orbslam2_torch.utils.device import resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32


def make_synthetic_ba(
    n_poses: int = 8,
    n_landmarks: int = 4096,
    obs_per_lm: int = 6,
    seed: int = 0,
    pixel_noise: float = 0.5,
    point_noise: float = 0.05,
    device=None,
) -> tuple[BAProblem, torch.Tensor]:
    """Synthetic depth-anchored BA problem with known structure.

    Returns (problem, intrinsics) on `device` (None = cuda:0).  Each landmark
    is observed by `obs_per_lm` consecutive poses (the local-window
    visibility pattern of a real map).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    P_num, L = n_poses, n_landmarks
    obs_per_lm = min(obs_per_lm, P_num)
    pts = rng.uniform([-4, -3, 2], [4, 3, 10], size=(L, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (P_num, 1, 1))
    poses[:, 0, 3] = 0.15 * np.arange(P_num)          # translate along x
    intr = np.asarray([400.0, 400.0, 320.0, 240.0], np.float32)

    first = rng.integers(0, P_num - obs_per_lm + 1, size=L)
    obs_lm = np.repeat(np.arange(L, dtype=np.int32), obs_per_lm)
    obs_kf = (np.repeat(first, obs_per_lm)
              + np.tile(np.arange(obs_per_lm), L)).astype(np.int32)

    T_cw = np.linalg.inv(poses)
    pc = (np.einsum("eij,ej->ei", T_cw[obs_kf][:, :3, :3], pts[obs_lm])
          + T_cw[obs_kf][:, :3, 3])
    uv = pc[:, :2] / pc[:, 2:3] * 400.0 + np.asarray([320.0, 240.0])
    uv = uv + rng.normal(0, pixel_noise, uv.shape)
    z = pc[:, 2] * (1.0 + rng.normal(0, 0.002, len(pc)))

    fixed = np.zeros(P_num, bool)
    fixed[0] = True
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    prob = BAProblem(
        poses=to(poses),
        points=to(pts + rng.normal(0, point_noise, pts.shape).astype(np.float32)),
        obs_kf=to(obs_kf),
        obs_lm=to(obs_lm),
        obs_uv=to(uv.astype(np.float32)),
        obs_z=to(z.astype(np.float32)),
        obs_z_valid=to(np.ones(len(obs_kf), bool)),
        obs_valid=to(np.ones(len(obs_kf), bool)),
        fixed=to(fixed),
    )
    return prob, to(intr)


def time_ba(
    prob: BAProblem, intr, cfg: BAConfig, reps: int = 3,
    fused: Optional[bool] = None, device=None,
) -> dict:
    """Warm up, then time `reps` runs of the full LM schedule on one device;
    returns {ms_per_iter, cost_drop}.  One host fetch (the cost trace) ends
    each run and forces its completion."""
    dev = resolve_device(device)
    set_exact_f32()

    def run():
        with torch.no_grad():
            _, _, stats = bundle_adjust(prob, intr, cfg, fused=fused,
                                        device=dev)
        tr = stats.cost.cpu().numpy()
        return float(tr[-1]), float(tr[0])

    cost_final, cost0 = run()                          # build + warm
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        dts.append(time.perf_counter() - t0)
    return {
        "ms_per_iter": 1e3 * min(dts) / cfg.iters,
        "cost_drop": cost0 / max(cost_final, 1e-9),
    }
