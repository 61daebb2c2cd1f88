"""Trajectory evaluation: ATE / RPE against ground truth.

Counterpart of `jetracer_orbslam2_tpu/evaluation.py`: the standard TUM RGB-D
benchmark metrics (Sturm et al.) on (N, 4, 4) tensors, on whatever device
the trajectories live on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jetracer_orbslam2_torch.ops import geometry as geo

Tensor = torch.Tensor


class AteResult(NamedTuple):
    rmse: Tensor
    mean: Tensor
    median: Tensor
    max: Tensor
    T_align: Tensor  # (4, 4) similarity/rigid alignment est -> gt


def umeyama_alignment(src: Tensor, dst: Tensor, with_scale: bool = False):
    """Least-squares similarity transform aligning (N,3) src to dst.

    Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = torch.mean(src, 0)
    mu_d = torch.mean(dst, 0)
    s_c = src - mu_s
    d_c = dst - mu_d
    cov = d_c.T @ s_c / src.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U @ Vt))
    one = torch.ones_like(d)
    diag = torch.stack([one, one, d])
    R = U @ torch.diag(diag) @ Vt
    if with_scale:
        var_s = torch.mean(torch.sum(s_c * s_c, -1))
        scale = torch.sum(S * diag) / torch.clamp_min(var_s, 1e-12)
    else:
        scale = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def ate(est_poses: Tensor, gt_poses: Tensor, with_scale: bool = False) -> AteResult:
    """Absolute trajectory error after rigid (or Sim3) alignment.

    est_poses, gt_poses: (N, 4, 4) T_wc.
    """
    p_est = est_poses[:, :3, 3]
    p_gt = gt_poses[:, :3, 3]
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
    p_aligned = s * p_est @ R.T + t
    err = torch.linalg.norm(p_aligned - p_gt, dim=-1)
    # median of an even count averages the two middle values (numpy/JAX
    # convention; torch.median would take the lower one)
    return AteResult(
        rmse=torch.sqrt(torch.mean(err ** 2)),
        mean=torch.mean(err),
        median=torch.quantile(err, 0.5),
        max=torch.max(err),
        T_align=geo.pose_from_rt(s * R, t),
    )


def _relative_errors(est_poses: Tensor, gt_poses: Tensor, delta: int):
    """Per-segment (translation error, rotation error [rad], gt length)."""
    def rel(T):
        return geo.pose_inverse(T[:-delta]) @ T[delta:]

    rel_gt = rel(gt_poses)
    e = geo.pose_inverse(rel_gt) @ rel(est_poses)
    trans = torch.linalg.norm(e[:, :3, 3], dim=-1)
    trace = e[:, 0, 0] + e[:, 1, 1] + e[:, 2, 2]
    rot = torch.arccos(torch.clamp((trace - 1) / 2, -1, 1))
    seg = torch.linalg.norm(rel_gt[:, :3, 3], dim=-1)
    return trans, rot, seg


def rpe(est_poses: Tensor, gt_poses: Tensor, delta: int = 1):
    """Relative pose error over a fixed frame delta.

    Returns (trans_rmse, rot_rmse_rad).
    """
    trans, rot, _ = _relative_errors(est_poses, gt_poses, delta)
    return torch.sqrt(torch.mean(trans ** 2)), torch.sqrt(torch.mean(rot ** 2))


def rpe_drift(est_poses: Tensor, gt_poses: Tensor, delta: int = 10):
    """Drift rate: relative-pose error normalized by distance travelled
    (the KITTI odometry convention).  Returns (trans_drift_frac,
    rot_rad_per_m): sum of segment errors over sum of ground-truth segment
    lengths, a length-weighted average robust to near-zero-motion segments.
    """
    trans, rot, seg = _relative_errors(est_poses, gt_poses, delta)
    total = torch.clamp_min(torch.sum(seg), 1e-9)
    return torch.sum(trans) / total, torch.sum(rot) / total


def rpe_drift_median(est_poses: Tensor, gt_poses: Tensor, delta: int = 10):
    """Median per-segment drift ratio: robust to the tail of segments that
    cross tracking dropouts (motion-model freerun then re-lock), which
    dominate the length-weighted mean of `rpe_drift` whenever tracked_frac <
    1.  Report both: mean = includes every failure, median = the typical
    drift while tracking.  Returns (trans_drift_frac, rot_rad_per_m)."""
    trans, rot, seg = _relative_errors(est_poses, gt_poses, delta)
    seg = torch.clamp_min(seg, 1e-9)
    # median of an even count averages the two middle values, as in JAX
    return torch.quantile(trans / seg, 0.5), torch.quantile(rot / seg, 0.5)
