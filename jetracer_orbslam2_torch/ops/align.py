"""Depth-to-colour alignment, depth sampling and keypoint backprojection.

Counterpart of `jetracer_orbslam2_tpu/ops/align.py`.  `align_depth_to_color`
re-renders an UNREGISTERED depth map into the colour camera: a nearest-pixel
z-buffer, written as one `scatter_reduce_(..., "amin")` into an inf-filled
buffer.  A minimum does not depend on the order of its operands, so the
result repeats bit for bit on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jetracer_orbslam2_torch.ops import geometry
from jetracer_orbslam2_torch.utils.device import as_f32, resolve_device

Tensor = torch.Tensor


def align_depth_to_color(
    depth: Tensor,
    depth_intrinsics: Tensor,
    color_intrinsics: Tensor,
    T_color_depth: Tensor,
    color_shape: tuple,
    depth_dist: Tensor | None = None,
    color_dist: Tensor | None = None,
    device=None,
) -> Tensor:
    """Re-render a depth map into the colour camera's frame.

    depth: (Hd, Wd) float32 metres, 0 = invalid.  Returns (Hc, Wc) float32
    metres aligned to the colour camera, 0 where no depth lands.  Each depth
    pixel is deprojected, moved into the colour frame, projected and rounded
    to the nearest colour pixel (the expression order of the reference);
    where several land on one pixel, the nearest surface wins.  Runs on
    `cuda:0` (raising without one) unless `device` says otherwise.
    """
    dev = resolve_device(device)
    depth, depth_intrinsics, color_intrinsics, T_color_depth = (
        as_f32(a, dev) for a in (depth, depth_intrinsics, color_intrinsics,
                                 T_color_depth))
    depth_dist, color_dist = (None if a is None else as_f32(a, dev)
                              for a in (depth_dist, color_dist))
    hd, wd = depth.shape
    hc, wc = color_shape
    f32 = torch.float32
    yy = torch.arange(hd, dtype=f32, device=dev)[:, None].expand(hd, wd)
    xx = torch.arange(wd, dtype=f32, device=dev)[None, :].expand(hd, wd)
    pix = torch.stack([xx, yy], -1).reshape(-1, 2)
    z = depth.reshape(-1)
    pts_d = geometry.deproject(pix, z, depth_intrinsics, depth_dist)
    pts_c = geometry.transform_points(T_color_depth, pts_d)
    uv = geometry.project(pts_c, color_intrinsics, color_dist)
    zc = pts_c[:, 2]
    inf = torch.full_like(zc, float("inf"))
    valid = (z > 0) & (zc > 0)
    u = torch.round(uv[:, 0]).to(torch.int32)
    v = torch.round(uv[:, 1]).to(torch.int32)
    inb = (u >= 0) & (u < wc) & (v >= 0) & (v < hc)
    zval = torch.where(valid & inb, zc, inf)
    idx = (torch.clamp(v, 0, hc - 1).long() * wc
           + torch.clamp(u, 0, wc - 1).long())
    out = torch.full((hc * wc,), float("inf"), dtype=f32, device=dev)
    out.scatter_reduce_(0, idx, zval, reduce="amin", include_self=True)
    out = out.reshape(hc, wc)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def sample_depth(depth: Tensor, xy: Tensor, radius: int = 1) -> Tensor:
    """Sample depth at (K, 2) float pixel coords.

    Takes the minimum VALID depth in a (2r+1)^2 neighbourhood (robust to the
    speckle holes typical of RGB-D sensors).  Returns (K,) metres, 0 invalid.
    The whole map is min-pooled once (max-pool of the negation, +inf padding
    at the edges) and one element is gathered per keypoint; min/max select a
    value, so the result is exact.
    """
    h, w = depth.shape
    p = 2 * radius + 1
    inf = torch.full_like(depth, float("inf"))
    neg = -torch.where(depth > 0, depth, inf)
    pooled = -F.max_pool2d(neg[None, None], kernel_size=p, stride=1,
                           padding=radius)[0, 0]
    xi = torch.clamp(torch.round(xy[:, 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).long(), 0, h - 1)
    best = pooled[yi, xi]
    return torch.where(torch.isfinite(best), best, torch.zeros_like(best))


def backproject_keypoints(
    xy: Tensor,
    depth: Tensor,
    intrinsics: Tensor,
    dist: Tensor | None = None,
    model: str = "brown_conrady",
    min_depth: float = 0.05,
    max_depth: float = 8.0,
) -> tuple[Tensor, Tensor]:
    """Keypoints (K, 2) + aligned depth map -> camera-frame 3D (K, 3) + mask.

    `xy` are RAW pixel coords (the depth map is registered to the raw
    image); `dist`/`model` undistort the ray before scaling by depth.
    """
    z = sample_depth(depth, xy)
    pts = geometry.deproject(xy, z, intrinsics, dist, model)
    valid = (z > min_depth) & (z < max_depth)
    return pts, valid
