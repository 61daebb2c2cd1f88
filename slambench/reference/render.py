"""Ray-cast box room with exact depth and poses: the traffic's frames and
their ground truth.

A frozen plain copy of the renderer of `jetracer_orbslam2_torch/io/synthetic`
(the room's six textured planes, the bilinear wrapping texture lookup, the
single-rounding hit point, the lap trajectory), so the benchmark's inputs do
not move when the program's module changes.  Textures come from a numpy
generator seeded by the run's seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

# Box planes: (normal, offset, texture-axis-u, texture-axis-v).
# Camera starts at the origin looking +z; y is down.
PLANES = (
    ((0.0, 0.0, 1.0), 5.0, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),    # back z=5
    ((1.0, 0.0, 0.0), -2.5, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),   # left x=-2.5
    ((1.0, 0.0, 0.0), 2.5, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),    # right x=2.5
    ((0.0, 1.0, 0.0), 1.8, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),    # floor y=1.8
    ((0.0, 1.0, 0.0), -1.8, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),   # ceiling
    ((0.0, 0.0, 1.0), -3.0, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),   # front z=-3
)


def make_texture(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """Blocky mosaic plus multiscale noise: strong FAST corners, distinct
    BRIEF patches.  (size, size) float32 grey levels."""
    coarse = rng.random((size // 16, size // 16), dtype=np.float32)
    blocks = np.kron(coarse, np.ones((16, 16), np.float32))
    mid = np.kron(rng.random((size // 4, size // 4), dtype=np.float32),
                  np.ones((4, 4), np.float32))
    fine = rng.random((size, size), dtype=np.float32)
    tex = 0.6 * blocks + 0.3 * mid + 0.1 * fine
    return (tex * 255.0).astype(np.float32)


def make_textures(seed: int, size: int = 256) -> np.ndarray:
    """(planes, size, size) float32 textures, one a plane, from `seed`."""
    rng = np.random.default_rng(seed)
    return np.stack([make_texture(rng, size) for _ in range(len(PLANES))])


def _sample_texture(tex: Tensor, u: Tensor, v: Tensor,
                    scale: float = 64.0) -> Tensor:
    size = tex.shape[0]
    x, y = u * scale, v * scale
    xf, yf = torch.floor(x), torch.floor(y)
    fx, fy = x - xf, y - yf
    x0, y0 = xf.long(), yf.long()

    def at(yi, xi):
        return tex[torch.remainder(yi, size), torch.remainder(xi, size)]

    return (at(y0, x0) * (1 - fx) * (1 - fy)
            + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy
            + at(y0 + 1, x0 + 1) * fx * fy)


@torch.no_grad()
def render_frame(T_wc: Tensor, intrinsics: Tensor, textures: Tensor,
                 shape: tuple) -> tuple[Tensor, Tensor]:
    """One pinhole view of the room from camera-to-world pose `T_wc`:
    (grey (H, W), camera-z depth (H, W)) on the device of `T_wc`."""
    h, w = shape
    dev, f32 = T_wc.device, torch.float32
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    yy = torch.arange(h, dtype=f32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)
    xn, yn = (xx - cx) / fx, (yy - cy) / fy
    d_cam = torch.stack([xn, yn, torch.ones((h, w), dtype=f32, device=dev)], -1)
    R, o = T_wc[:3, :3], T_wc[:3, 3]
    d_w = d_cam @ R.T
    best_t = torch.full((h, w), float("inf"), dtype=f32, device=dev)
    best_val = torch.zeros((h, w), dtype=f32, device=dev)
    for i, (n, c, ax_u, ax_v) in enumerate(PLANES):
        n = torch.tensor(n, dtype=f32, device=dev)
        ax_u = torch.tensor(ax_u, dtype=f32, device=dev)
        ax_v = torch.tensor(ax_v, dtype=f32, device=dev)
        denom = d_w @ n
        t = (c - o @ n) / torch.where(torch.abs(denom) < 1e-9,
                                      torch.full_like(denom, 1e-9), denom)
        # o + t * d with one rounding: texel coordinates are hit * 64
        hit = (o.double() + t[..., None].double() * d_w.double()).float()
        val = _sample_texture(textures[i], hit @ ax_u, hit @ ax_v)
        ok = (t > 0.1) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_val = torch.where(ok, val, best_val)
    depth = torch.where(torch.isfinite(best_t), best_t, torch.zeros_like(best_t))
    return best_val, depth


def hat(w: Tensor) -> Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([torch.stack([zeros, -wz, wy], -1),
                        torch.stack([wz, zeros, -wx], -1),
                        torch.stack([-wy, wx, zeros], -1)], -2)


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues, Taylor-guarded near 0: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-8
    one = torch.ones_like(theta)
    A = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    W = hat(w)
    eye = torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)
    return eye + A * W + B * (W @ W)


def pose_from_rt(R: Tensor, t: Tensor) -> Tensor:
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def lap_trajectory(n_frames: int, radius: float, center_z: float,
                   lap_frames: int, device="cpu") -> Tensor:
    """(N, 4, 4) camera-to-world poses on a clockwise circle of `radius`
    about (0, 0, center_z), the heading turning with the position: after
    `lap_frames` frames the camera is back at its start pose and heading."""
    i = torch.arange(n_frames, dtype=torch.float32, device=device)
    phi = 2.0 * math.pi * i / lap_frames
    x = radius * torch.sin(phi)
    z = center_z - radius * torch.cos(phi)
    w = torch.stack([torch.zeros_like(phi), phi, torch.zeros_like(phi)], -1)
    t = torch.stack([x, torch.zeros_like(x), z], -1)
    return pose_from_rt(so3_exp(w), t)
