"""Trajectory error against ground truth (the TUM RGB-D benchmark's ATE):
a plain NumPy copy of the Umeyama alignment of `evaluation.ate`, in float64.
"""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rigid (R, t) with dst ~= R @ src + t, least squares over (N, 3)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / src.shape[0]
    U, _, Vt = np.linalg.svd(cov)
    diag = np.array([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ np.diag(diag) @ Vt
    return R, mu_d - R @ mu_s


def position_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-pose translation error (m) of (N, 4, 4) camera-to-world `est`
    against `gt` after the rigid alignment of all N positions."""
    p_est = est[:, :3, 3].astype(np.float64)
    p_gt = gt[:, :3, 3].astype(np.float64)
    R, t = umeyama(p_est, p_gt)
    return np.linalg.norm(p_est @ R.T + t - p_gt, axis=-1)


def rmse(err: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(err)))) if err.size else float("nan")
