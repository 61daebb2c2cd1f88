"""Fused FAST corner response + 3x3 local-max: the hand-written CUDA kernel's
wrappers, with their plain PyTorch version beside them.

Replaces the TPU kernel `jetracer_orbslam2_tpu/ops/pallas_fast.py::
fast_nms_response` (a Pallas kernel holding the whole image in VMEM, called
once per level and per threshold).  The CUDA source is
`jetracer_orbslam2_torch/csrc/fast_nms.cu`: ONE launch takes every level of
a pyramid (up to 8) and one or two thresholds.  One block per 32x16 tile of
any level; each tile plus a 4-pixel halo is staged in shared memory with
`cp.async`, the ring differences are computed once a pixel and scored
against each threshold, and the 3x3 max follows in shared memory.

Bound on the card: each level read once and each (level, threshold) output
written once, 4 * (1 + T) * sum(H*W) bytes: 3,264,000 B = 0.97 us (one
threshold) and 4,896,000 B = 1.46 us (two) for the 640x480 4-level pyramid.
A launch's fixed cost is larger than that, so the design's first aim is one
launch a frame instead of one per level and threshold; the ring masks, the
excess sums and the pre-NMS scores never leave the chip.

The kernel is bit-exact against `fast_nms_pyramid_reference` for any input:
both accumulate the 16 excess terms of a threshold in the order i = 0..15 in
float32.
"""

from __future__ import annotations

import ctypes

import torch

from jetracer_orbslam2_torch.ops import fast, nms
from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.step_graph import note_launch

Tensor = torch.Tensor

_LIB_NAME = "fast_nms"
# Must equal MAX_LEVELS / MAX_THRESHOLDS in csrc/fast_nms.cu.
MAX_LEVELS, MAX_THRESHOLDS = 8, 2


def _launcher():
    lib = cuda_build.load_library(_LIB_NAME)
    fn = lib.fast_nms_pyramid_launch
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, i32, i32, i32, ptr]
        fn.restype = i32
        lib.fast_nms_max_levels.restype = i32
        if lib.fast_nms_max_levels() != MAX_LEVELS:
            raise RuntimeError("MAX_LEVELS differs between ops/fused_fast.py "
                               "and csrc/fast_nms.cu")
    return fn


def fast_nms_response_reference(img: Tensor, threshold: float,
                                arc_length: int = 12, border: int = 3) -> Tensor:
    """Plain version of one (level, threshold) pair:
    `local_max_3x3(fast_score_map(...))`."""
    return nms.local_max_3x3(
        fast.fast_score_map(img, threshold, arc_length, border))


def fast_nms_pyramid_reference(levels, thresholds, arc_length: int = 12,
                               border: int = 3) -> list[list[Tensor]]:
    """Plain version of `fast_nms_pyramid`: the loop over
    `fast_nms_response_reference`.  Used on CPU tensors and as the yardstick
    the kernel is held against on the card."""
    return [[fast_nms_response_reference(img, t, arc_length, border)
             for img in levels] for t in thresholds]


def _check(levels: list, thresholds: list, arc_length: int,
           border: int) -> torch.device:
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels, got {len(levels)}")
    if not 1 <= len(thresholds) <= MAX_THRESHOLDS:
        raise ValueError(f"1..{MAX_THRESHOLDS} thresholds, got {len(thresholds)}")
    dev = levels[0].device
    for img in levels:
        if img.dim() != 2:
            raise ValueError(f"a level must be 2-D (H, W), got shape {tuple(img.shape)}")
        if img.dtype != torch.float32:
            raise TypeError(f"levels must be float32, got {img.dtype}")
        if not img.is_contiguous():
            raise ValueError("levels must be contiguous")
        if img.device != dev:
            raise ValueError(f"levels lie on {img.device} and {dev}")
    if border < 3:
        raise ValueError("border must be >= 3 (the ring radius)")
    if not 1 <= arc_length <= 16:
        raise ValueError("arc_length must be in 1..16")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"levels live on {dev}, the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    return dev


def fast_nms_pyramid(levels, thresholds, arc_length: int = 12,
                     border: int = 3) -> list[list[Tensor]]:
    """Levels [(H_i, W_i) f32] x thresholds [t_j] -> out[j][i], the (H_i, W_i)
    3x3-suppressed FAST response of level i at t_j.

    CUDA tensors: ONE kernel launch on the current stream (no sync; the
    outputs are views of one `torch.empty` buffer); raises if it does not
    build, load or launch.  CPU tensors: the plain version.
    """
    levels = list(levels)
    thresholds = [float(t) for t in thresholds]
    dev = _check(levels, thresholds, arc_length, border)
    if dev.type == "cpu":
        return fast_nms_pyramid_reference(levels, thresholds, arc_length, border)
    sizes = [img.numel() for img in levels]
    total = sum(sizes)
    buf = torch.empty(len(thresholds) * total, dtype=torch.float32, device=dev)
    outs, at = [], 0
    for _ in thresholds:
        row = []
        for img, size in zip(levels, sizes):
            row.append(buf[at:at + size].view(img.shape))
            at += size
        outs.append(row)
    if total == 0:
        return outs
    launch = _launcher()
    n = len(levels)
    imgs = (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels])
    out_ptrs = (ctypes.c_void_p * (n * len(thresholds)))(
        *[o.data_ptr() for row in outs for o in row])
    hs = (ctypes.c_int * n)(*[img.shape[0] for img in levels])
    ws = (ctypes.c_int * n)(*[img.shape[1] for img in levels])
    ts = (ctypes.c_float * len(thresholds))(*thresholds)
    err = launch(imgs, out_ptrs, hs, ws, n, ts, len(thresholds),
                 int(arc_length), int(border),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {err}")
    note_launch(fast_nms_pyramid)
    return outs


def fast_nms_response(img: Tensor, threshold: float, arc_length: int = 12,
                      border: int = 3) -> Tensor:
    """(H, W) f32 grayscale -> (H, W) f32 3x3-suppressed FAST response: the
    one-level, one-threshold call of `fast_nms_pyramid` (same kernel, same
    launch count, same device rule)."""
    return fast_nms_pyramid([img], [threshold], arc_length, border)[0][0]


fast_nms_pyramid.launches = 0
