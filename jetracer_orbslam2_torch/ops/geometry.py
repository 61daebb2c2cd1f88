"""SE(3)/SO(3) Lie algebra, camera projection models, and Kabsch alignment.

Counterpart of `jetracer_orbslam2_tpu/ops/geometry.py`: everything float32
and batch-first, same formulas and guards, written with torch ops.  Small
matrix products go through `@` (full f32: see utils/precision.py).
"""

from __future__ import annotations

import numpy as np
import torch

from jetracer_orbslam2_torch.utils.consts import const_table
from jetracer_orbslam2_torch.utils.ties import first_argmax

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------


def hat(w: Tensor) -> Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], -1),
            torch.stack([wz, zeros, -wx], -1),
            torch.stack([-wy, wx, zeros], -1),
        ],
        -2,
    )


def _rodrigues_coeffs(w: Tensor):
    """theta^2 (...,1,1), the small-angle mask, and the A, B coefficients
    (Taylor-guarded near theta = 0)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-8
    one = torch.ones_like(theta)
    A = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    return theta2, small, A, B


def _eye_like(W: Tensor) -> Tensor:
    n = W.shape[-1]
    return torch.eye(n, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    _, _, A, B = _rodrigues_coeffs(w)
    W = hat(w)
    return _eye_like(W) + A * W + B * (W @ W)


def so3_log(R: Tensor) -> Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    # off-diagonal antisymmetric part
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    sin_t = torch.sin(theta)
    small = torch.abs(sin_t) < 1e-6
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t)),
    )
    w = scale[..., None] * v
    # near theta = pi the antisymmetric part vanishes; recover the axis from
    # the symmetric part (diagonal of R + I)
    near_pi = theta[..., None] > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    # fix signs using off-diagonals
    one = torch.ones_like(trace)
    sx = torch.where(R[..., 1, 0] + R[..., 0, 1] >= 0, one, -one)
    sy = torch.where(R[..., 2, 1] + R[..., 1, 2] >= 0, one, -one)
    signs = torch.stack([one, sx, sx * sy], -1)
    w_pi = axis * signs * theta[..., None]
    return torch.where(near_pi, w_pi, w)


def se3_exp(xi: Tensor) -> Tensor:
    """(..., 6) twist [v, w] -> (..., 4, 4) homogeneous transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2, small, A, B = _rodrigues_coeffs(w)
    W = hat(w)
    W2 = W @ W
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - A) / torch.where(small, torch.ones_like(theta2), theta2))
    eye = _eye_like(W)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = (V @ v[..., None])[..., 0]
    return pose_from_rt(R, t)


def se3_log(T: Tensor) -> Tensor:
    """(..., 4, 4) -> (..., 6) twist [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    theta2, small, A, B = _rodrigues_coeffs(w)
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta2)(1 - A/(2B)) W^2
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / torch.where(small, torch.ones_like(theta2), theta2),
    )
    Vinv = _eye_like(W) - 0.5 * W + coef * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], -1)


def pose_from_rt(R: Tensor, t: Tensor) -> Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    # assembled by concatenation: writing a Python scalar into a slice of a
    # device tensor (T[..., 3, 3] = 1.0) makes the host wait for the device
    bottom = const_table(
        "pose_bottom_row", lambda: np.float32([0.0, 0.0, 0.0, 1.0]),
        R.device).to(R.dtype)
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def pose_inverse(T: Tensor) -> Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return pose_from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: Tensor, pts: Tensor) -> Tensor:
    """Apply (..., 4, 4) to (..., N, 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


# ---------------------------------------------------------------------------
# Camera model (pinhole + Brown-Conrady / FTheta)
# ---------------------------------------------------------------------------


def distort_brown_conrady(xy: Tensor, dist: Tensor) -> Tensor:
    """Apply Brown-Conrady distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    f = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * f + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * f + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_brown_conrady(xy: Tensor, dist: Tensor, iters: int = 8) -> Tensor:
    """Invert distortion by fixed-point iteration (fixed count)."""
    guess = xy
    for _ in range(iters):
        guess = xy - (distort_brown_conrady(guess, dist) - guess)
    return guess


def distort_ftheta(xy: Tensor, dist: Tensor) -> Tensor:
    """FTheta (equidistant fisheye) distortion on normalized coords.

    dist[0] = w, the FOV parameter: a ray at normalized radius r lands at
    distorted radius rd = atan(2 r tan(w/2)) / w."""
    w = torch.clamp_min(dist[0], 1e-6)
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(x * x + y * y)
    r_safe = torch.clamp_min(r, 1e-9)
    rd = torch.arctan(2.0 * r_safe * torch.tan(w * 0.5)) / w
    s = rd / r_safe
    return xy * s[..., None]


def undistort_ftheta(xy: Tensor, dist: Tensor) -> Tensor:
    """Exact inverse of distort_ftheta (closed form)."""
    w = torch.clamp_min(dist[0], 1e-6)
    x, y = xy[..., 0], xy[..., 1]
    rd = torch.sqrt(x * x + y * y)
    rd_safe = torch.clamp_min(rd, 1e-9)
    r = torch.tan(rd_safe * w) / (2.0 * torch.tan(w * 0.5))
    s = r / rd_safe
    return xy * s[..., None]


_DISTORT = {"brown_conrady": distort_brown_conrady, "ftheta": distort_ftheta}
_UNDISTORT = {"brown_conrady": undistort_brown_conrady,
              "ftheta": undistort_ftheta}


def _safe_z(z: Tensor) -> Tensor:
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def undistort_pixels(xy: Tensor, intrinsics: Tensor, dist: Tensor | None,
                     model: str = "brown_conrady",
                     rect: Tensor | None = None) -> Tensor:
    """RAW pixel coords (..., 2) -> ideal-pinhole pixel coords.

    Keypoints are measured on the raw image and their COORDINATES are
    undistorted once — image pixels never resample.  `rect` (3, 3), when
    given, additionally rotates the undistorted ray into a rectified frame.
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    xyn = torch.stack([xn, yn], -1)
    if dist is not None:
        xyn = _UNDISTORT[model](xyn, dist)
    if rect is not None:
        ray = torch.stack(
            [xyn[..., 0], xyn[..., 1], torch.ones_like(xyn[..., 0])], -1)
        ray = ray @ rect.T
        xyn = ray[..., :2] / _safe_z(ray[..., 2])[..., None]
    return torch.stack([xyn[..., 0] * fx + cx, xyn[..., 1] * fy + cy], -1)


def distort_pixels(xy: Tensor, intrinsics: Tensor, dist: Tensor | None,
                   model: str = "brown_conrady",
                   rect: Tensor | None = None) -> Tensor:
    """Ideal-pinhole pixel coords (..., 2) -> RAW pixel coords (the inverse
    of `undistort_pixels`, same `rect` convention)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    xyn = torch.stack([xn, yn], -1)
    if rect is not None:
        ray = torch.stack(
            [xyn[..., 0], xyn[..., 1], torch.ones_like(xyn[..., 0])], -1)
        ray = ray @ rect            # rect^-1 = rect^T applied to rays
        xyn = ray[..., :2] / _safe_z(ray[..., 2])[..., None]
    if dist is not None:
        xyn = _DISTORT[model](xyn, dist)
    return torch.stack([xyn[..., 0] * fx + cx, xyn[..., 1] * fy + cy], -1)


def project(points: Tensor, intrinsics: Tensor, dist: Tensor | None = None,
            model: str = "brown_conrady") -> Tensor:
    """Camera-frame 3D (..., 3) -> pixel coords (..., 2).

    `intrinsics` = [fx, fy, cx, cy].  Points behind the camera project to
    whatever z<=0 gives; callers mask with `points[..., 2] > 0`.
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    xy = points[..., :2] / _safe_z(points[..., 2])[..., None]
    if dist is not None:
        xy = _DISTORT[model](xy, dist)
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], -1)


def deproject(pixels: Tensor, depth: Tensor, intrinsics: Tensor,
              dist: Tensor | None = None,
              model: str = "brown_conrady") -> Tensor:
    """Pixel coords (..., 2) + depth (...) -> camera-frame 3D (..., 3)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    x = (pixels[..., 0] - cx) / fx
    y = (pixels[..., 1] - cy) / fy
    xy = torch.stack([x, y], -1)
    if dist is not None:
        xy = _UNDISTORT[model](xy, dist)
    return torch.stack([xy[..., 0] * depth, xy[..., 1] * depth, depth], -1)


# ---------------------------------------------------------------------------
# Kabsch / Umeyama best-fit rigid transform
# ---------------------------------------------------------------------------


def _centered_correlation(src: Tensor, dst: Tensor, weights: Tensor | None):
    """Weighted centroids and H = sum_i w_i s_i d_i^T -> (..., 3, 3)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None]
    wsum = torch.clamp_min(
        torch.sum(weights, -1, keepdim=True)[..., None], 1e-9)
    mu_s = torch.sum(src * w, -2, keepdim=True) / wsum
    mu_d = torch.sum(dst * w, -2, keepdim=True) / wsum
    s = src - mu_s
    d = dst - mu_d
    H = (s * w).transpose(-1, -2) @ d
    return mu_s, mu_d, H


def _adjugate_tables():
    """Index tables of the 16 cofactors of a 4x4: entry e = 4*j + i is the
    cofactor of (row j, col i) — its 3 kept rows, its 3 kept columns and its
    sign — stacked as one (3, 16, 3) int64 array [rows, cols, sign]."""
    idx = [0, 1, 2, 3]
    rows, cols, sign = [], [], []
    for j in idx:
        for i in idx:
            rows.append([r for r in idx if r != j])
            cols.append([c for c in idx if c != i])
            sign.append([(-1) ** (i + j)] * 3)
    return np.asarray([rows, cols, sign], dtype=np.int64)


def _adjugate_columns(A: Tensor) -> Tensor:
    """(..., 4, 4) -> (..., 4, 4) whose [j, :] is column j of adj(A) (the
    cofactors of row j), all 16 3x3 minors expanded in one pass."""
    tab = const_table("adjugate4", _adjugate_tables, A.device)
    rows, cols, sign = tab[0], tab[1], tab[2, :, 0].to(A.dtype)
    m = A[..., rows[:, :, None], cols[:, None, :]]         # (..., 16, 3, 3)
    det = (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                           - m[..., 1, 2] * m[..., 2, 1])
           - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                             - m[..., 1, 2] * m[..., 2, 0])
           + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                             - m[..., 1, 1] * m[..., 2, 0]))
    return (sign * det).reshape(A.shape)


def kabsch_quat(src: Tensor, dst: Tensor, weights: Tensor | None = None,
                newton_iters: int = 30) -> Tensor:
    """Weighted rigid transform via the quaternion characteristic polynomial
    (QCP / Theobald) — the SVD-free Kabsch for BATCHED hypothesis solving.

    The optimal rotation is the top eigenvector of Horn's symmetric 4x4 K
    built from the correlation H.  The largest eigenvalue comes from Newton
    on the characteristic quartic (monotone from the upper bound
    sqrt(tr K^2)) and the eigenvector from the adjugate of K - lambda I:
    closed-form, branch-free, elementwise arithmetic over the batch.
    Returns a PROPER rotation by construction.  Used for RANSAC hypothesis
    batches; winners are refit with the exact `kabsch`.
    """
    mu_s, mu_d, H = _centered_correlation(src, dst, weights)

    hxx, hxy, hxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    hyx, hyy, hyz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    hzx, hzy, hzz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    row0 = torch.stack([hxx + hyy + hzz, hyz - hzy, hzx - hxz, hxy - hyx], -1)
    row1 = torch.stack([hyz - hzy, hxx - hyy - hzz, hxy + hyx, hzx + hxz], -1)
    row2 = torch.stack([hzx - hxz, hxy + hyx, -hxx + hyy - hzz, hyz + hzy], -1)
    row3 = torch.stack([hxy - hyx, hzx + hxz, hyz + hzy, -hxx - hyy + hzz], -1)
    K = torch.stack([row0, row1, row2, row3], -2)        # (..., 4, 4)

    # characteristic quartic of the traceless K via trace powers:
    # f(x) = x^4 + e2 x^2 - e3 x + e4, e2 = -p2/2, e3 = p3/3,
    # e4 = (p2^2/2 - p4)/4 with pk = tr(K^k)
    K2 = K @ K
    p2 = torch.diagonal(K2, dim1=-2, dim2=-1).sum(-1)
    p3 = torch.sum(K2 * K.transpose(-1, -2), (-2, -1))
    p4 = torch.sum(K2 * K2.transpose(-1, -2), (-2, -1))
    e2 = -0.5 * p2
    e3 = p3 / 3.0
    e4 = (0.5 * p2 * p2 - p4) * 0.25
    lam = torch.sqrt(torch.clamp_min(p2, 1e-30))      # upper bound >= lam_max
    tiny = torch.full_like(lam, 1e-20)
    neg_e3, two_e2 = -e3, 2.0 * e2
    for _ in range(newton_iters):
        # Horner steps as addcmul (x + a*b in one op): the frame loop is bound
        # by the number of small launches, and this loop is most of them
        # f = ((lam^2 + e2) lam - e3) lam + e4
        f = torch.addcmul(e2, lam, lam)
        f = torch.addcmul(neg_e3, f, lam)
        f = torch.addcmul(e4, f, lam)
        # f' = (4 lam^2 + 2 e2) lam - e3
        fp = torch.addcmul(two_e2, lam, lam, value=4.0)
        fp = torch.addcmul(neg_e3, fp, lam)
        fp = torch.where(torch.abs(fp) < 1e-20, tiny, fp)
        lam = torch.addcdiv(lam, f, fp, value=-1.0)

    # eigenvector = any nonzero column of adj(K - lam I) (rank-1 for a
    # simple eigenvalue); take the largest-norm column for stability
    A = K - lam[..., None, None] * _eye_like(K)

    adj_cols = _adjugate_columns(A)                       # (..., 4cols, 4)
    norms = torch.linalg.norm(adj_cols, dim=-1)
    _, best = first_argmax(norms, -1)
    q = torch.take_along_dim(
        adj_cols, best[..., None, None].expand(best.shape + (1, 4)),
        dim=-2)[..., 0, :]
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-20)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)
    t = mu_d[..., 0, :] - (R @ mu_s[..., 0, :, None])[..., 0]
    return pose_from_rt(R, t)


def kabsch(src: Tensor, dst: Tensor, weights: Tensor | None = None) -> Tensor:
    """Weighted rigid transform T (4,4) minimizing ||T@src - dst||^2.

    src, dst: (N, 3); weights: (N,) nonnegative (mask doubles as weight).
    Batched over leading dims if present.  CUDA tensors go through the K5
    kernel (`ops/fused_rigid.rigid_fit`: no host wait, so a frame step that
    refits can be captured into a CUDA graph); CPU tensors through its plain
    version, the SVD route.  SVD factors differ in sign between libraries and
    devices; only the resulting transform is defined.
    """
    from jetracer_orbslam2_torch.ops import fused_rigid

    return fused_rigid.rigid_fit(src, dst, weights)
