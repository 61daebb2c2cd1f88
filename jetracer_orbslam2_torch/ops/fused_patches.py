"""Keypoint patch extraction through the hand-written gather kernel, with the
kernel's plain PyTorch version beside it.

Replaces the TPU kernel `scripts/experiment_pallas_patches.py::make_kernel` /
`pallas_extract` (a Pallas kernel that slices an aligned window per keypoint
out of the VMEM-resident canvas and rolls it into place).  The CUDA source is
`jetracer_orbslam2_torch/csrc/patch_gather.cu`: one block per keypoint,
consecutive threads on consecutive output elements.

Contract: `patch_gather(canvas (R, W) f32, ys (K,) i32, xs (K,) i32, P)` gives
`out[k, i, j] = canvas[ys[k] + i, xs[k] + j]`, reads clamped into the canvas.
`extract_patches_fused(levels, kp, P)` packs the pyramid into the canvas,
turns each keypoint into the canvas position of its window's first pixel and
calls `patch_gather`; it computes `ops/patches.extract_patches` bit for bit
(a copy of pixels) wherever every level holds a whole patch.

Bound on the card: bytes, K*P*P*4 written once and the canvas and origins read
once (7.9 MB at K = 1024, P = 37 on the 900 x 640 canvas, about 2.4 us at
3.35 TB/s); nothing but addresses is computed.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from jetracer_orbslam2_torch.ops import patches
from jetracer_orbslam2_torch.ops.nms import Keypoints
from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.consts import const_table

Tensor = torch.Tensor

_LIB_NAME = "patch_gather"


def _launcher():
    lib = cuda_build.load_library(_LIB_NAME)
    fn = lib.patch_gather_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def patch_gather_reference(canvas: Tensor, ys: Tensor, xs: Tensor,
                           patch_size: int) -> Tensor:
    """Plain version: one advanced-index gather on the canvas.  Used on CPU
    tensors and as the yardstick the kernel is held against on the card."""
    rows, cols = canvas.shape
    offs = torch.arange(patch_size, device=canvas.device)
    y = (ys.long()[:, None] + offs).clamp_(0, rows - 1)          # (K, P)
    x = (xs.long()[:, None] + offs).clamp_(0, cols - 1)          # (K, P)
    return canvas[y[:, :, None], x[:, None, :]]


def _check(canvas: Tensor, ys: Tensor, xs: Tensor, patch_size: int) -> None:
    if canvas.dim() != 2 or canvas.numel() == 0:
        raise ValueError(
            f"canvas must be a non-empty (R, W), got shape {tuple(canvas.shape)}")
    if canvas.dtype != torch.float32:
        raise TypeError(f"canvas must be float32, got {canvas.dtype}")
    if patch_size < 1:
        raise ValueError("patch_size must be >= 1")
    for name, v in (("ys", ys), ("xs", xs)):
        if v.dim() != 1 or v.shape != ys.shape:
            raise ValueError(f"{name} must be (K,), got shape {tuple(v.shape)}")
        if v.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {v.dtype}")
        if v.device != canvas.device:
            raise ValueError(f"{name} lives on {v.device}, canvas on {canvas.device}")
    if not (canvas.is_contiguous() and ys.is_contiguous() and xs.is_contiguous()):
        raise ValueError("canvas, ys and xs must be contiguous")


def patch_gather(canvas: Tensor, ys: Tensor, xs: Tensor, patch_size: int) -> Tensor:
    """(R, W) f32 canvas, (K,) i32 window origins -> (K, P, P) f32 patches.

    CUDA tensors: launches the kernel on the current stream (no sync, output
    from `torch.empty`) and raises if it does not build, load or launch.
    CPU tensors: the plain version.
    """
    _check(canvas, ys, xs, patch_size)
    if canvas.device.type == "cpu":
        return patch_gather_reference(canvas, ys, xs, patch_size)
    if canvas.device.type != "cuda":
        raise ValueError(f"unsupported device {canvas.device}")
    k = ys.shape[0]
    out = torch.empty((k, patch_size, patch_size), dtype=torch.float32,
                      device=canvas.device)
    if k == 0:
        return out
    launch = _launcher()
    if canvas.device.index != torch.cuda.current_device():
        raise ValueError(f"canvas lives on {canvas.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    stream = torch.cuda.current_stream().cuda_stream
    err = launch(canvas.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
                 canvas.shape[0], canvas.shape[1], k, int(patch_size), stream)
    if err != 0:
        raise RuntimeError(f"patch_gather kernel launch failed: cudaError {err}")
    patch_gather.launches += 1
    return out


patch_gather.launches = 0


def patch_origins(levels: List[Tensor], offsets, kp: Keypoints,
                  patch_size: int) -> tuple[Tensor, Tensor]:
    """Canvas (row, column) of the first pixel of every keypoint's window:
    the centre clamped into the keypoint's own level, moved to the level's
    rows of the canvas, minus the patch radius.  (K,) int32 each."""
    r = patch_size // 2
    heights = [im.shape[0] for im in levels]
    widths = [im.shape[1] for im in levels]
    layout = const_table(
        ("canvas_layout", tuple(offsets), tuple(heights), tuple(widths)),
        lambda: np.asarray([offsets, heights, widths], np.int32),
        levels[0].device)
    lvl_off, lvl_h, lvl_w = layout[:, kp.level.long()]          # (K,) each
    yc = torch.minimum(torch.clamp_min(kp.xy_level[:, 1], r), lvl_h - 1 - r)
    xc = torch.minimum(torch.clamp_min(kp.xy_level[:, 0], r), lvl_w - 1 - r)
    return ((yc + lvl_off - r).to(torch.int32).contiguous(),
            (xc - r).to(torch.int32).contiguous())


def extract_patches_fused(levels: List[Tensor], kp: Keypoints,
                          patch_size: int) -> Tensor:
    """(K, P, P) float32 patches centred on each keypoint (level-local):
    `ops/patches.extract_patches` through the gather kernel."""
    canvas, offsets = patches.pack_levels(levels)
    ys, xs = patch_origins(levels, offsets, kp, patch_size)
    return patch_gather(canvas.contiguous(), ys, xs, patch_size)
