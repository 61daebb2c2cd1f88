"""Batched keypoint patch extraction by direct gather.

Counterpart of `jetracer_orbslam2_tpu/ops/patches.py`.  The JAX version packs
the pyramid into one canvas and selects columns with a one-hot matmul because
the TPU has no fast random-access gather; a GPU has one, so here every level
is flattened into one 1-D buffer and each patch pixel is fetched by one
advanced-index gather.  Values are pure copies of pixels, so the result is
bit-exact whatever the method.

`extract_patches` is the plain version of the hand-written gather kernel's
levels entry (`ops/fused_patches.extract_patches_fused`), which the front-end
calls: it reads the pyramid levels themselves, so the main path packs no
canvas.  `pack_levels` builds the packed canvas of the TPU kernel's own
contract, whose counterpart is the kernel's canvas entry
(`fused_patches.patch_gather`); it stays for that entry and its tests.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from jetracer_orbslam2_torch.ops.nms import Keypoints
from jetracer_orbslam2_torch.utils.consts import const_table

Tensor = torch.Tensor


def pack_levels(levels: List[Tensor]) -> tuple[Tensor, tuple[int, ...]]:
    """Stack pyramid levels vertically into one (sum_h, W0) canvas.

    Returns (canvas, per-level row offsets).  Levels narrower than level 0
    are zero-padded on the right; a keypoint's level-local (x, y) maps to
    canvas (x, y + offset[level]).
    """
    w0 = levels[0].shape[1]
    offsets, rows, off = [], [], 0
    for img in levels:
        h, w = img.shape
        offsets.append(off)
        rows.append(torch.nn.functional.pad(img, (0, w0 - w)) if w < w0 else img)
        off += h
    return torch.cat(rows, 0), tuple(offsets)


def extract_patches(levels: List[Tensor], kp: Keypoints, patch_size: int) -> Tensor:
    """(K, P, P) float32 patches centered on each keypoint (level-local).

    Centers are clamped to keep the window inside the keypoint's own level;
    the detector border (FrontendConfig.fast_border >= patch radius) makes
    clamping a no-op for valid keypoints.
    """
    p = patch_size
    r = p // 2
    dev = levels[0].device
    heights = [im.shape[0] for im in levels]
    widths = [im.shape[1] for im in levels]
    starts = [0]
    for h, w in zip(heights[:-1], widths[:-1]):
        starts.append(starts[-1] + h * w)
    flat = torch.cat([im.reshape(-1) for im in levels])

    layout = const_table(
        ("level_layout", tuple(heights), tuple(widths)),
        lambda: np.asarray([starts, heights, widths], np.int64), dev)
    lvl_start, lvl_h, lvl_w = layout[:, kp.level.long()]            # (K,) each
    yc = torch.minimum(torch.clamp_min(kp.xy_level[:, 1].long(), r), lvl_h - 1 - r)
    xc = torch.minimum(torch.clamp_min(kp.xy_level[:, 0].long(), r), lvl_w - 1 - r)

    offs = torch.arange(-r, r + 1, device=dev)
    ys = yc[:, None] + offs[None, :]                                # (K, P)
    xs = xc[:, None] + offs[None, :]                                # (K, P)
    idx = (lvl_start[:, None, None] + ys[:, :, None] * lvl_w[:, None, None]
           + xs[:, None, :])                                        # (K, P, P)
    # a level smaller than the patch leaves the clamp range empty; keep the
    # gather in range (such keypoints are never valid)
    return flat[idx.clamp_(0, flat.numel() - 1)]
