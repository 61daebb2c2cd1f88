"""Keypoint overlay raster: burn marker dots into a grayscale frame.

Counterpart of `jetracer_orbslam2_tpu/ops/overlay.py` (the reference's debug
raster, src/cuda/post_processing.cu:45-70: a 2x2 white dot at each keypoint
before JPEG encoding).  One masked write of fixed shape, plain PyTorch on any
device; `runtime.telemetry.TelemetryPublisher` calls it when server-side
burn-in is asked for (the shipped viewer composites the overlay client-side
instead, viewer/index.html).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def overlay_keypoints(gray: Tensor, xy: Tensor, valid: Tensor,
                      value: float = 255.0) -> Tensor:
    """Draw a 2x2 dot at each valid keypoint.

    gray: (H, W) float; xy: (K, 2) pixel coords; valid: (K,) bool.
    Returns the composited (H, W) image (out-of-bounds dots dropped).
    """
    H, W = gray.shape
    x0 = torch.floor(xy[:, 0]).to(torch.int64)
    y0 = torch.floor(xy[:, 1]).to(torch.int64)
    # 2x2 footprint (the reference draws pos + {0,1} in each axis):
    # dx = 0 1 0 1, dy = 0 0 1 1, made on the device (no host copy)
    corner = torch.arange(4, device=gray.device)
    xs = (x0[:, None] + (corner & 1)[None, :]).reshape(-1)
    ys = (y0[:, None] + (corner >> 1)[None, :]).reshape(-1)
    ok = (valid.repeat_interleave(4)
          & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H))
    flat = torch.where(ok, ys * W + xs, H * W)       # OOB -> extra slot
    out = torch.cat([gray.reshape(-1), gray.new_zeros(1)])
    out.index_put_((flat,), torch.full(flat.shape, value, dtype=gray.dtype,
                                       device=gray.device))
    return out[:H * W].reshape(H, W)
