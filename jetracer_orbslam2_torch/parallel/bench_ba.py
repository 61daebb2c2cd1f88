"""Bundle-adjustment benchmark problem, timing, and the scaling sweep.

Counterpart of `jetracer_orbslam2_tpu/parallel/bench_ba.py`:

  * `make_synthetic_ba` builds the standard synthetic problem (P poses in a
    line, L landmarks in a box, `obs_per_lm` observations each).  It is numpy
    with `default_rng(seed)`, so the arrays are the JAX package's bit for bit.
  * `time_ba` times the full LM schedule of `bundle_adjust` on one device
    with one host fetch per run.
  * `time_sharded_ba` times `sharded_bundle_adjust` inside the current
    process group of n ranks (a one-rank group is made when none is up):
    the program the live system runs a keyframe with a mesh.
  * `measure_scaling` starts one group of n processes per mesh size and
    reports ms per LM iteration and the strong-scaling efficiency
    t(1) / (n * t(n)).  It stops at the device count: one row on one card.
    The counterpart of `scripts/bench_ba_scaling.py` is this function and
    `chip_smoke.py` phase 21.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import tempfile
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


def time_sharded_ba(
    prob: BAProblem, intr, n_devices: int, cfg: BAConfig, reps: int = 3,
    device=None,
) -> dict:
    """Warm up, then time `reps` runs of the full LM schedule of
    `sharded_bundle_adjust` inside the current group of `n_devices` ranks
    (every rank calls it; with no group up and n_devices 1, a one-rank group
    is made for the call).  The warm run also builds the communicator (the
    first NCCL all-reduce does).  One host fetch (the cost trace) ends each
    run.  Returns {n, ms_per_iter, cost_drop}."""
    from jetracer_orbslam2_torch.parallel.ba_sharded import (
        prepare_sharded_problem, sharded_bundle_adjust)
    from jetracer_orbslam2_torch.parallel.mesh import make_mesh

    with make_mesh(n_devices, device=device) as mesh:
        sprob = prepare_sharded_problem(prob, n_devices, device=mesh.device)

        def run():
            _, _, trace = sharded_bundle_adjust(sprob, intr, cfg, mesh)
            tr = trace.cpu().numpy()
            return float(tr[-1]), float(tr[0])

        cost_final, cost0 = run()                      # build + warm
        dts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            dts.append(time.perf_counter() - t0)
    return {
        "n": n_devices,
        "ms_per_iter": 1e3 * min(dts) / cfg.iters,
        "cost_drop": cost0 / max(cost_final, 1e-9),
    }


# a group of measure_scaling that takes longer has hung or diverged
SCALING_TIMEOUT_S = 600.0


def _scaling_rank(rank: int, n: int, init_method: str, device: str,
                  problem: tuple, iters: int, reps: int, results) -> None:
    """One rank of `measure_scaling`'s group (a spawned process)."""
    from jetracer_orbslam2_torch.parallel import mesh as mesh_mod

    dev = torch.device(device) if device == "cpu" else torch.device("cuda", rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    mesh_mod.init_distributed(init_method, n, rank, device=dev)
    try:
        prob, intr = make_synthetic_ba(*problem, device=dev)
        row = time_sharded_ba(prob, intr, n, BAConfig(iters=iters), reps,
                              device=dev)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        results.put(row)


def measure_scaling(
    mesh_sizes=(1, 2, 4, 8),
    n_poses: int = 8,
    n_landmarks: int = 8192,
    obs_per_lm: int = 6,
    iters: int = 10,
    reps: int = 3,
    device=None,
) -> list[dict]:
    """Strong scaling: a fixed problem over growing groups, one process a
    rank (spawned, a FileStore in a temporary directory), rank r on
    cuda:r.  efficiency(n) = t(1) / (n * t(n)).  Stops at the device count
    (CUDA cards; the CPU's cores with device="cpu", the only way it runs
    on the CPU).  Each group must finish within SCALING_TIMEOUT_S."""
    dev = resolve_device(device)
    available = (torch.cuda.device_count() if dev.type == "cuda"
                 else os.cpu_count() or 1)
    ctx = multiprocessing.get_context("spawn")
    rows, t1 = [], None
    for n in mesh_sizes:
        if n > available:
            break
        with tempfile.TemporaryDirectory(prefix="jetracer_scaling_") as tmp:
            results = ctx.Queue()
            procs = [ctx.Process(
                target=_scaling_rank,
                args=(r, n, f"file://{os.path.join(tmp, 'store')}", dev.type,
                      (n_poses, n_landmarks, obs_per_lm), iters, reps,
                      results)) for r in range(n)]
            for p in procs:
                p.start()
            row, deadline = None, time.monotonic() + SCALING_TIMEOUT_S
            try:
                while row is None and time.monotonic() < deadline:
                    try:
                        row = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        if any(p.exitcode not in (None, 0) for p in procs):
                            break
            finally:
                for p in procs:
                    p.join(timeout=30)
                    if p.is_alive():
                        p.kill()
                        p.join()
            codes = [p.exitcode for p in procs]
            if row is None or any(codes):
                raise RuntimeError(f"scaling group of {n} failed: exit codes "
                                   f"{codes}")
        t1 = t1 if t1 is not None else row["ms_per_iter"]
        row["efficiency"] = t1 / (row["n"] * row["ms_per_iter"])
        rows.append(row)
    return rows
