"""Fused FAST corner response + 3x3 local-max: the hand-written CUDA kernel's
wrapper, with its plain PyTorch version beside it.

Replaces the TPU kernel `jetracer_orbslam2_tpu/ops/pallas_fast.py::
fast_nms_response` (a Pallas kernel holding the whole image in VMEM).  The
CUDA source is `jetracer_orbslam2_torch/csrc/fast_nms.cu`: one block per
32x16 output tile, the tile plus a 4-pixel halo staged in shared memory, the
bordered score for the tile plus a 1-pixel halo in a second shared array, a
barrier, then the 3x3 max.

Bound on the card: one f32 read and one f32 write per pixel (8*H*W bytes;
2.46 MB at 640x480) — memory-bound on paper and launch-bound in practice at
pyramid-level sizes.  The design keeps the ring masks, the excess sums and
the pre-NMS score out of device memory.

The kernel is bit-exact against `fast_nms_response_reference` for any input:
both accumulate the 16 excess terms in the order i = 0..15 in float32.
"""

from __future__ import annotations

import ctypes

import torch

from jetracer_orbslam2_torch.ops import fast, nms
from jetracer_orbslam2_torch.utils import cuda_build

Tensor = torch.Tensor

_LIB_NAME = "fast_nms"


def _launcher():
    lib = cuda_build.load_library(_LIB_NAME)
    fn = lib.fast_nms_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fast_nms_response_reference(img: Tensor, threshold: float,
                                arc_length: int = 12, border: int = 3) -> Tensor:
    """Plain version: `local_max_3x3(fast_score_map(...))`.  Used on CPU
    tensors and as the yardstick the kernel is held against on the card."""
    return nms.local_max_3x3(
        fast.fast_score_map(img, threshold, arc_length, border))


def _check(img: Tensor, arc_length: int, border: int) -> None:
    if img.dim() != 2:
        raise ValueError(f"img must be 2-D (H, W), got shape {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"img must be float32, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    if border < 3:
        raise ValueError("border must be >= 3 (the ring radius)")
    if not 1 <= arc_length <= 16:
        raise ValueError("arc_length must be in 1..16")


def fast_nms_response(img: Tensor, threshold: float, arc_length: int = 12,
                      border: int = 3) -> Tensor:
    """(H, W) f32 grayscale -> (H, W) f32 3x3-suppressed FAST response.

    CUDA tensor: launches the kernel on the current stream (no sync, output
    from `torch.empty`) and raises if it does not build, load or launch.
    CPU tensor: the plain version.
    """
    _check(img, arc_length, border)
    if img.device.type == "cpu":
        return fast_nms_response_reference(img, threshold, arc_length, border)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    launch = _launcher()
    h, w = img.shape
    if img.device.index != torch.cuda.current_device():
        raise ValueError(f"img lives on {img.device}, the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    stream = torch.cuda.current_stream().cuda_stream
    err = launch(img.data_ptr(), out.data_ptr(), h, w, float(threshold),
                 int(arc_length), int(border), stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {err}")
    fast_nms_response.launches += 1
    return out


fast_nms_response.launches = 0
