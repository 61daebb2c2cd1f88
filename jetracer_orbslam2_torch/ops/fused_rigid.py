"""Weighted rigid fit (Kabsch) through the hand-written CUDA kernel K5, with
its plain PyTorch version beside it.

`geometry.kabsch` routes here.  The plain version is the SVD route:
weighted centroids, the centred correlation H, `torch.linalg.svd`, the
det-flip guard.  On the card `torch.linalg.svd` makes the host wait
(cuSOLVER's info check reads the device back), which keeps a frame step out
of a CUDA graph; the kernel computes the same transform with no host wait.
It replaces no TPU kernel: the JAX package calls `jnp.linalg.svd` here,
outside any Pallas kernel.

The CUDA source is `jetracer_orbslam2_torch/csrc/rigid_fit.cu`: one block a
problem sums the points in f64 (a fixed-order tree, no atomics, so a
relaunch and a graph replay give the same bits), and one thread factors the
3 x 3 H by a one-sided Jacobi of fixed sweeps in f64 and writes T.

Bound on the card: a launch.  At B = 1, N = 1,024 it reads 28 KB.
"""

from __future__ import annotations

import ctypes

import torch

from jetracer_orbslam2_torch.ops.geometry import _centered_correlation, pose_from_rt
from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.step_graph import note_launch

Tensor = torch.Tensor

_LIB_NAME = "rigid_fit"


def _launcher():
    fn = cuda_build.load_library(_LIB_NAME).rigid_fit_launch
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
        fn.restype = i32
    return fn


def rigid_fit_reference(src: Tensor, dst: Tensor,
                        weights: Tensor | None = None) -> Tensor:
    """Plain version: the SVD route.  Used on CPU tensors and as the
    yardstick the kernel is held against on the card.  SVD factors differ in
    sign between libraries and devices; only the transform is defined."""
    mu_s, mu_d, H = _centered_correlation(src, dst, weights)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    # det flip guard: R = V diag(1, 1, det) U^T
    det = torch.sign(torch.linalg.det(V @ Ut))
    V_fixed = torch.cat([V[..., :, :2], V[..., :, 2:] * det[..., None, None]], -1)
    R = V_fixed @ Ut
    t = mu_d[..., 0, :] - (R @ mu_s[..., 0, :, None])[..., 0]
    return pose_from_rt(R, t)


def _check(src: Tensor, dst: Tensor, weights: Tensor | None) -> None:
    if src.dim() < 2 or src.shape[-1] != 3 or dst.shape != src.shape:
        raise ValueError(f"src and dst must be (..., N, 3) alike, got "
                         f"{tuple(src.shape)} and {tuple(dst.shape)}")
    if weights is not None and weights.shape != src.shape[:-1]:
        raise ValueError(f"weights must be {tuple(src.shape[:-1])}, got "
                         f"{tuple(weights.shape)}")
    for name, v in (("src", src), ("dst", dst), ("weights", weights)):
        if v is None:
            continue
        if v.device != src.device:
            raise ValueError(f"{name} lies on {v.device}, src on {src.device}")
        if v.device.type == "cuda" and v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {v.dtype}")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src.device}")
    if src.device.type == "cuda" and src.device.index != torch.cuda.current_device():
        raise ValueError(f"src lives on {src.device}, the current CUDA device "
                         f"is {torch.cuda.current_device()}")


def rigid_fit(src: Tensor, dst: Tensor, weights: Tensor | None = None) -> Tensor:
    """(..., N, 3) src, dst and (..., N) weights (None: all 1) -> (..., 4, 4)
    T minimizing sum w ||T @ src - dst||^2, a proper rotation.

    CUDA tensors (float32): ONE kernel launch on the current stream (no
    sync, output from `torch.empty`); raises if it does not build, load or
    launch.  CPU tensors: the plain version.
    """
    _check(src, dst, weights)
    if src.device.type == "cpu":
        return rigid_fit_reference(src, dst, weights)
    lead, n = src.shape[:-2], src.shape[-2]
    s = src.reshape(-1, n, 3).contiguous()
    d = dst.reshape(-1, n, 3).contiguous()
    w = None if weights is None else weights.reshape(-1, n).contiguous()
    b = s.shape[0]
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=src.device)
    if b == 0:
        return out.reshape(lead + (4, 4))
    err = _launcher()(s.data_ptr(), d.data_ptr(),
                      None if w is None else w.data_ptr(), out.data_ptr(),
                      b, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rigid_fit kernel launch failed: cudaError {err}")
    note_launch(rigid_fit)
    return out.reshape(lead + (4, 4))


rigid_fit.launches = 0
