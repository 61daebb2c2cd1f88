"""Distributed bundle adjustment: landmark blocks over the ranks of a mesh.

Counterpart of `jetracer_orbslam2_tpu/parallel/ba_sharded.py`:

  * Observations live on the dense (P, L) pose-by-landmark grid
    (`models/backend/ba.py`) split on the landmark axis: rank r owns columns
    [r*Lb, (r+1)*Lb).  Hll, bl, the cross blocks G and the landmark
    back-substitution are local to a rank (no communication), and every
    rank does the same work (empty slots cost what valid ones cost).
  * Each rank forms its partial reduced camera system and its partial Hpp,
    bp and cost; an LM iteration sums the four pose-sized partials in ONE
    all-reduce (`Mesh.psum_many`: 2,688 floats at P 8) and its cost in
    another (`Mesh.psum`), and every rank solves the same reduced system.
    The traffic an LM iteration is O(P^2), whatever the landmark count.  On
    a mesh K8 cannot serve (more than 8 ranks, several hosts) these are the
    group's own all-reduces, and `slam_scan` runs the windowed BA in its
    host-branch step instead of a frame graph's keyframe body.
  * The per-slot math is `ba.lm_run_dense` itself (psum=mesh.psum,
    psum_many=mesh.psum_many), so the one-rank and the unsharded solvers
    cannot drift apart: on one rank the all-reduce of a partial is the
    partial.  On a CUDA device each rank runs the fused kernels (K2 and K3,
    `ops/fused_ba.py`) on its block, as the unsharded solve does.

Where the port differs: the JAX package returns the points as a sharded
global array, and its `Slam` holds a map whose landmark axis is sharded.
Here every rank runs the whole system with a replicated map, so after the
solve each rank's block of points reaches every rank (`Mesh.gather_blocks`).
Poses and the cost trace are replicated by construction: every rank solves
the same all-reduced system.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from jetracer_orbslam2_torch.config import BAConfig
from jetracer_orbslam2_torch.models.backend import ba as ba_core
from jetracer_orbslam2_torch.models.backend.map import MapState, _map_to
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.parallel.mesh import Mesh
from jetracer_orbslam2_torch.utils.device import as_f32, resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32

Tensor = torch.Tensor


class ShardedBAProblem(NamedTuple):
    """A BA problem on the dense (P, L_pad) SoA grid for an n-rank mesh.

    The landmark axis (always last) is padded to a multiple of n; rank r owns
    columns [r*Lb, (r+1)*Lb).  Empty grid slots carry w = 0, padded columns
    lm_valid = False.  Every rank holds the whole problem and slices its
    block.
    """

    poses: Tensor       # (P, 4, 4) T_wc
    points: Tensor      # (L_pad, 3)
    obs_uv: Tensor      # (2, P, L_pad)
    obs_z: Tensor       # (P, L_pad)
    obs_z_valid: Tensor  # (P, L_pad) bool
    obs_w: Tensor       # (P, L_pad) float32 slot weights
    fixed: Tensor       # (P,) bool
    lm_valid: Tensor    # (L_pad,) bool (False for padding)


def prepare_sharded_problem(
    prob: ba_core.BAProblem, n_devices: int, device=None,
) -> ShardedBAProblem:
    """Host-side layout: scatter the edge list onto the dense grid and pad
    the landmark axis to a multiple of the mesh size; the result goes to
    `device` (None = cuda:0, "cpu" on request)."""
    dev = resolve_device(device)
    host = lambda a: (a.cpu().numpy() if isinstance(a, Tensor)  # noqa: E731
                      else np.asarray(a))
    P_num = prob.poses.shape[0]
    L = prob.points.shape[0]
    Lb = -(-L // n_devices)
    L_pad = Lb * n_devices

    kf = host(prob.obs_kf)
    lm = host(prob.obs_lm)
    ok = host(prob.obs_valid)
    uv = np.zeros((2, P_num, L_pad), np.float32)
    z = np.zeros((P_num, L_pad), np.float32)
    zok = np.zeros((P_num, L_pad), bool)
    w = np.zeros((P_num, L_pad), np.float32)
    uv[:, kf[ok], lm[ok]] = host(prob.obs_uv)[ok].T
    z[kf[ok], lm[ok]] = host(prob.obs_z)[ok]
    zok[kf[ok], lm[ok]] = host(prob.obs_z_valid)[ok]
    w[kf[ok], lm[ok]] = 1.0

    pts = np.zeros((L_pad, 3), np.float32)
    pts[:L] = host(prob.points)
    lm_valid = np.zeros(L_pad, bool)
    lm_valid[:L] = True

    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return ShardedBAProblem(
        poses=to(host(prob.poses).astype(np.float32)), points=to(pts),
        obs_uv=to(uv), obs_z=to(z), obs_z_valid=to(zok), obs_w=to(w),
        fixed=to(host(prob.fixed).astype(bool)), lm_valid=to(lm_valid))


def _sharded_lm_run(poses_wc, points, obs: ba_core.DenseObs, fixed,
                    lm_valid, intrinsics, cfg: BAConfig, mesh: Mesh,
                    fused=None) -> tuple[Tensor, Tensor, Tensor]:
    """The LM schedule on this rank's block of a replicated dense problem.
    points (L, 3) and the grids' last axis are whole; L must be a multiple
    of the mesh size.  Returns (poses T_wc, points (L, 3) gathered on every
    rank, cost trace)."""
    blk = mesh.block(points.shape[0])
    local = ba_core.DenseObs(*(f[..., blk].contiguous() for f in obs))
    poses_cw, pts, trace = ba_core.lm_run_dense(
        geo.pose_inverse(poses_wc), points[blk].contiguous(), local, fixed,
        lm_valid[blk].contiguous(), intrinsics, cfg, psum=mesh.psum,
        fused=fused, device=mesh.device, psum_many=mesh.psum_many)
    return geo.pose_inverse(poses_cw), mesh.gather_blocks(pts), trace


def sharded_bundle_adjust(
    sprob: ShardedBAProblem, intrinsics, cfg: BAConfig, mesh: Mesh,
    fused: Optional[bool] = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """LM bundle adjustment over the mesh on a host-prepared problem
    (`prepare_sharded_problem` for the mesh's size).  Every rank calls it
    with the same problem.  Returns (poses T_wc, points (L_pad, 3), cost
    trace), the same on every rank.  fused: `ba.lm_run_dense`'s (None: the
    kernels on a CUDA device, the dense route on the CPU)."""
    dev = mesh.device
    set_exact_f32()
    s = ShardedBAProblem(*(torch.as_tensor(f).to(dev) for f in sprob))
    obs = ba_core.DenseObs(uv=s.obs_uv, z=s.obs_z, z_valid=s.obs_z_valid,
                           w=s.obs_w)
    with torch.no_grad():
        return _sharded_lm_run(s.poses, s.points, obs, s.fixed, s.lm_valid,
                               as_f32(intrinsics, dev), cfg, mesh, fused)


def sharded_local_ba(
    m: MapState, intrinsics, window_size: int, cfg, mesh: Mesh,
) -> tuple[MapState, Tensor]:
    """Windowed BA over the newest keyframes, landmark-sharded on `mesh`.

    Drop-in for `models/slam.local_ba`: the same window and gauge
    (`slam.window_problem`), the same grid (`ba.edges_to_dense`), the same
    per-slot math, with the landmark axis split over the ranks and the
    reduced camera system all-reduced (one O(P^2) collective of the four
    partials and one of the cost an LM iteration).  On one rank it is
    `local_ba`, bit for bit.

    Returns (new MapState, n_dropped): a (landmark, window-pose) pair
    observed twice keeps one observation, and n_dropped (a device scalar)
    counts such collisions (0 in practice).  Raises ValueError when the
    landmark capacity does not split into the mesh's blocks.
    """
    from jetracer_orbslam2_torch.models import slam as slam_mod

    L = m.lm_pos.shape[0]
    if L % mesh.size:
        raise ValueError(
            f"landmark capacity must divide the mesh: L={L} n={mesh.size}")
    dev = mesh.device
    set_exact_f32()
    m = _map_to(m, dev)
    intrinsics = as_f32(intrinsics, dev)
    prob, window = slam_mod.window_problem(m, window_size)
    obs, n_dropped = ba_core.edges_to_dense(
        window_size, L, prob.obs_kf, prob.obs_lm, prob.obs_uv, prob.obs_z,
        prob.obs_z_valid, prob.obs_valid)
    with torch.no_grad():
        new_poses, new_points, _ = _sharded_lm_run(
            prob.poses, prob.points, obs, prob.fixed, m.lm_valid, intrinsics,
            cfg.ba, mesh)
    # repeated window slots are all gauge-fixed and carry the same pose
    kf_pose = m.kf_pose.index_copy(0, window, new_poses)
    lm_pos = torch.where(m.lm_valid[:, None], new_points, m.lm_pos)
    return m._replace(kf_pose=kf_pose, lm_pos=lm_pos), n_dropped
