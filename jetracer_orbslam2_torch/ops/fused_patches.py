"""Keypoint patch extraction through the hand-written gather kernel, with the
kernel's plain PyTorch versions beside it.

Replaces the TPU kernel `scripts/experiment_pallas_patches.py::make_kernel` /
`pallas_extract` (a Pallas kernel that slices an aligned window per keypoint
out of the VMEM-resident packed canvas and rolls it into place).  The CUDA
source is `jetracer_orbslam2_torch/csrc/patch_gather.cu`; its header gives
the design.  It has two entries that share one store loop (a flat run of
16-byte stores over the (K, P, P) output):

- `extract_patches_fused(levels, kp, P)`, the front-end's path: one launch a
  frame that reads the windows straight from the pyramid levels (a by-value
  table of up to 8 level pointers) and computes each keypoint's window
  itself.  No canvas is packed and no origin is computed outside the kernel.
  It equals `ops/patches.extract_patches(levels, kp, P)` bit for bit, a
  keypoint on a level smaller than the patch included (its window is clamped
  into the concatenated levels, as the plain version does).
- `patch_gather(canvas (R, W) f32, ys (K,) i32, xs (K,) i32, P)`, the TPU
  kernel's own contract: `out[k, i, j] = canvas[ys[k] + i, xs[k] + j]`, reads
  clamped per axis into the canvas.  `patches.pack_levels` and
  `patch_origins` build its inputs; the front-end no longer calls them.

Bound on the card: bytes, the output written once and each input read once
(7.25 MB at 640x480, four levels, K = 1024, P = 37 by the levels entry:
about 2.2 us at 3.35 TB/s); nothing but addresses is computed.
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
from jetracer_orbslam2_torch.utils.step_graph import note_launch

Tensor = torch.Tensor

_LIB_NAME = "patch_gather"
# Must equal MAX_LEVELS in csrc/patch_gather.cu.
MAX_LEVELS = 8


def _library():
    lib = cuda_build.load_library(_LIB_NAME)
    if lib.patch_gather_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.patch_gather_launch.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.patch_gather_launch.restype = i32
        lib.patch_levels_launch.argtypes = (
            [ptr] * 3 + [i32] + [ptr] * 3 + [i32] * 2 + [ptr])
        lib.patch_levels_launch.restype = i32
        lib.patch_max_levels.restype = i32
        if lib.patch_max_levels() != MAX_LEVELS:
            raise RuntimeError("MAX_LEVELS differs between ops/fused_patches.py "
                               "and csrc/patch_gather.cu")
    return lib


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
    launch = _library().patch_gather_launch
    if canvas.device.index != torch.cuda.current_device():
        raise ValueError(f"canvas lives on {canvas.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    stream = torch.cuda.current_stream().cuda_stream
    err = launch(canvas.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
                 canvas.shape[0], canvas.shape[1], k, int(patch_size), stream)
    if err != 0:
        raise RuntimeError(f"patch_gather kernel launch failed: cudaError {err}")
    note_launch(patch_gather)
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


def _check_levels(levels: List[Tensor], kp: Keypoints,
                  patch_size: int) -> torch.device:
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels, got {len(levels)}")
    dev = levels[0].device
    for img in levels:
        if img.dim() != 2 or img.numel() == 0:
            raise ValueError("a level must be a non-empty (H, W), got shape "
                             f"{tuple(img.shape)}")
        if img.dtype != torch.float32:
            raise TypeError(f"levels must be float32, got {img.dtype}")
        if not img.is_contiguous():
            raise ValueError("levels must be contiguous")
        if img.device != dev:
            raise ValueError(f"levels lie on {img.device} and {dev}")
    if patch_size < 1:
        raise ValueError("patch_size must be >= 1")
    level, xy = kp.level, kp.xy_level
    if level.dim() != 1 or xy.shape != (level.shape[0], 2):
        raise ValueError(f"kp.level must be (K,) and kp.xy_level (K, 2), got "
                         f"{tuple(level.shape)} and {tuple(xy.shape)}")
    for name, v in (("kp.level", level), ("kp.xy_level", xy)):
        if v.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.device != dev:
            raise ValueError(f"{name} lies on {v.device}, the levels on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"levels live on {dev}, the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    return dev


def extract_patches_fused(levels: List[Tensor], kp: Keypoints,
                          patch_size: int) -> Tensor:
    """(K, P, P) float32 patches centred on each keypoint (level-local),
    read straight from the pyramid levels: `ops/patches.extract_patches` bit
    for bit.  levels: 1..8 contiguous (H_i, W_i) float32 on one device;
    kp.level (K,) and kp.xy_level (K, 2) int32, contiguous, on that device.

    CUDA tensors: ONE kernel launch on the current stream (no sync, output
    from `torch.empty`, no other op); raises if it does not build, load or
    launch.  CPU tensors: the plain version, `patches.extract_patches`.
    """
    levels = list(levels)
    dev = _check_levels(levels, kp, patch_size)
    if dev.type == "cpu":
        return patches.extract_patches(levels, kp, patch_size)
    k = kp.level.shape[0]
    out = torch.empty((k, patch_size, patch_size), dtype=torch.float32,
                      device=dev)
    if k == 0:
        return out
    launch = _library().patch_levels_launch
    n = len(levels)
    imgs = (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels])
    hs = (ctypes.c_int * n)(*[img.shape[0] for img in levels])
    ws = (ctypes.c_int * n)(*[img.shape[1] for img in levels])
    err = launch(imgs, hs, ws, n, kp.level.data_ptr(), kp.xy_level.data_ptr(),
                 out.data_ptr(), k, int(patch_size),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"patch_levels kernel launch failed: cudaError {err}")
    note_launch(extract_patches_fused)
    return out


extract_patches_fused.launches = 0
