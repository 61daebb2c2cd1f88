"""Depth sampling and keypoint backprojection.

Counterpart of `jetracer_orbslam2_tpu/ops/align.py`.  `align_depth_to_color`
(re-rendering an UNREGISTERED depth map into the color frame) is not ported
yet; the frontend raises when a configuration asks for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jetracer_orbslam2_torch.ops import geometry

Tensor = torch.Tensor


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
