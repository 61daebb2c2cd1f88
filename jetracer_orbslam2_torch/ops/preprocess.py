"""Image preprocessing: RGB->gray, 3x3 Gaussian blur, halfsample pyramid.

Counterpart of `jetracer_orbslam2_tpu/ops/preprocess.py`.  All functions take
(..., H, W) float32 and are written as shifted slices with a fixed order of
additions — not as `conv2d`/`avg_pool2d`: a library convolution may run in
TF32 on the card and may sum in another order, and the BRIEF bits downstream
are exact sign tests on these pixels.
"""

from __future__ import annotations

from typing import List

import torch

Tensor = torch.Tensor

# B*0.07 + G*0.72 + R*0.21, the weights of the system this one descends from.
_RGB_WEIGHTS = (0.21, 0.72, 0.07)


def rgb_to_gray(rgb: Tensor) -> Tensor:
    """(..., H, W, 3) uint8/float -> (..., H, W) float32 grayscale."""
    rgb = rgb.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return _RGB_WEIGHTS[0] * r + _RGB_WEIGHTS[1] * g + _RGB_WEIGHTS[2] * b


def _blur_axis(x: Tensor, axis: int) -> Tensor:
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    return (0.25 * lo + 0.5 * x) + 0.25 * hi


def gaussian_blur_3x3(img: Tensor) -> Tensor:
    """Separable [1 2 1]/4 x [1 2 1]/4 blur with edge-replicate borders
    (columns first, then rows)."""
    img = img.to(torch.float32)
    return _blur_axis(_blur_axis(img, -1), -2)


def halfsample(img: Tensor) -> Tensor:
    """2x2 box-filter downsample; odd sizes are edge-padded first so level
    shapes are ceil-half."""
    h, w = img.shape[-2], img.shape[-1]
    if h % 2:
        img = torch.cat([img, img[..., -1:, :]], -2)
    if w % 2:
        img = torch.cat([img, img[..., :, -1:]], -1)
    s = ((img[..., 0::2, 0::2] + img[..., 0::2, 1::2])
         + img[..., 1::2, 0::2]) + img[..., 1::2, 1::2]
    return 0.25 * s


def build_pyramid(img: Tensor, num_levels: int) -> List[Tensor]:
    """Blur then halfsample per level; level 0 = input resolution."""
    levels = [img.to(torch.float32)]
    for _ in range(num_levels - 1):
        levels.append(halfsample(gaussian_blur_3x3(levels[-1])))
    return levels
