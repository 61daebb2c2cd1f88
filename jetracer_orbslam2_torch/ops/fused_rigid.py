"""Weighted rigid fit (Kabsch) through the hand-written CUDA kernel K5, with
its plain PyTorch version beside it.

Two entries, one kernel source and one launch counter (`rigid_fit.launches`):

- `rigid_fit(src, dst, weights)`: one fit.  `geometry.kabsch` routes here.
- `rigid_refit(src, dst, w1, keep, gate)`: the refit pair of
  `tracking.ransac_kabsch` and of the SLAM map refit in one launch: fit with
  w1, gate the residuals at that fit, fit again on the points kept.

The plain versions are the SVD route: weighted centroids, the centred
correlation H, `torch.linalg.svd`, the det-flip guard; the refit's is that
fit, `transform_points`, the gate and the fit again, as the two call sites
computed it.  On the card `torch.linalg.svd` makes the host wait (cuSOLVER's
info check reads the device back), which keeps a frame step out of a CUDA
graph; the kernel computes the same transforms with no host wait.  It
replaces no TPU kernel: the JAX package calls `jnp.linalg.svd` here, outside
any Pallas kernel.

The CUDA source is `jetracer_orbslam2_torch/csrc/rigid_fit.cu`: one block a
problem loads the points into shared memory once (up to MAX_POINTS pairs;
above, it reads them from global memory on each pass), sums 16 moments in
f64 in one fixed-order reduction (no atomics, so a relaunch and a graph
replay give the same bits), and one thread finds the rotation as the top eigenvector of
Horn's 4 x 4 matrix (Newton on its characteristic quartic with a convergence
exit, then an adjugate row) and writes T.

Bound on the card: latency (a launch, a reduction, a short dependent
chain); at B = 1, N = 1,024 a fit reads 28 KB.
"""

from __future__ import annotations

import ctypes
from numbers import Real

import torch

from jetracer_orbslam2_torch.ops.geometry import (
    _centered_correlation, pose_from_rt, transform_points)
from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.step_graph import note_launch

Tensor = torch.Tensor

_LIB_NAME = "rigid_fit"
# the limit of the kernel's staged path (csrc/rigid_fit.cu's MAX_N): up to
# MAX_POINTS pairs a problem, src, dst and the per-point weights, keep and
# gate are copied into one block's shared memory (36 bytes a point, 221,184
# bytes at the limit); a larger N takes the streamed path, which reads them
# from global memory on each pass.  Not a limit of the wrappers.
MAX_POINTS = 6144

_ptrs: dict[str, object] = {}


def _launchers():
    """(rigid_fit_launch, rigid_refit_launch), the library built and set up
    (the staged kernels allowed MAX_POINTS' shared memory) at the first
    call."""
    if not _ptrs:
        lib = cuda_build.load_library(_LIB_NAME)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fit, refit = lib.rigid_fit_launch, lib.rigid_refit_launch
        fit.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
        refit.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_float, ptr, ptr,
                          ptr, i32, i32, ptr]
        fit.restype = refit.restype = lib.rigid_fit_setup.restype = i32
        err = lib.rigid_fit_setup()
        if err != 0:
            raise RuntimeError(f"rigid_fit setup failed: cudaError {err}")
        _ptrs.update(fit=fit, refit=refit)
    return _ptrs["fit"], _ptrs["refit"]


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


def rigid_refit_reference(src: Tensor, dst: Tensor, w1: Tensor, keep: Tensor,
                          gate: Tensor | float) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of `rigid_refit`: the two SVD fits and the ops between
    them, as `ransac_kabsch` and the map refit computed them; a batch is a
    loop over its problems, so each row is the bits of its problem alone
    (a batched SVD is not)."""
    if src.dim() > 2:
        lead, n = src.shape[:-2], src.shape[-2]
        flat = [x.reshape((-1,) + tuple(x.shape[len(lead):]))
                if isinstance(x, Tensor) else x for x in (src, dst, w1, keep, gate)]
        rows = [rigid_refit_reference(*(x[i] if isinstance(x, Tensor) else x
                                        for x in flat))
                for i in range(flat[0].shape[0])]
        if not rows:
            return (src.new_zeros(lead + (4, 4)), src.new_zeros(lead + (n,)),
                    torch.zeros(lead, dtype=torch.int32, device=src.device))
        return tuple(torch.stack(x).reshape(lead + tuple(x[0].shape))
                     for x in zip(*rows))
    T1 = rigid_fit_reference(src, dst, w1)
    err = torch.linalg.norm(transform_points(T1, src) - dst, dim=-1)
    w2 = keep * (err < gate)
    T2 = rigid_fit_reference(src, dst, w2)
    return T2, w2, torch.count_nonzero(w2, dim=-1).to(torch.int32)


def _check(src: Tensor, dst: Tensor, **per_point) -> None:
    """src and dst (..., N, 3) alike, each of `per_point` None or (..., N),
    all on src's device, float32 on the card, the card the current CUDA
    device."""
    if src.dim() < 2 or src.shape[-1] != 3 or dst.shape != src.shape:
        raise ValueError(f"src and dst must be (..., N, 3) alike, got "
                         f"{tuple(src.shape)} and {tuple(dst.shape)}")
    tensors = {"src": src, "dst": dst}
    for name, v in per_point.items():
        if v is None:
            continue
        if not isinstance(v, Tensor) or v.shape != src.shape[:-1]:
            shape = tuple(v.shape) if isinstance(v, Tensor) else type(v).__name__
            raise ValueError(f"{name} must be {tuple(src.shape[:-1])}, got {shape}")
        tensors[name] = v
    for name, v in tensors.items():
        if v.device != src.device:
            raise ValueError(f"{name} lies on {v.device}, src on {src.device}")
        if v.device.type == "cuda" and v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {v.dtype}")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src.device}")
    if src.device.type == "cuda":
        if src.device.index != torch.cuda.current_device():
            raise ValueError(f"src lives on {src.device}, the current CUDA "
                             f"device is {torch.cuda.current_device()}")


def _flat(x: Tensor | None, n: int, width: int = 0) -> Tensor | None:
    """x as a contiguous (B, N) or (B, N, width) tensor."""
    if x is None:
        return None
    return x.reshape((-1, n, width) if width else (-1, n)).contiguous()


def _ptr(x: Tensor | None):
    return None if x is None else x.data_ptr()


def _launched(err: int, entry: str) -> None:
    """Raises unless the launch succeeded; counts it."""
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    note_launch(rigid_fit)


def rigid_fit(src: Tensor, dst: Tensor, weights: Tensor | None = None) -> Tensor:
    """(..., N, 3) src, dst and (..., N) weights (None: all 1) -> (..., 4, 4)
    T minimizing sum w ||T @ src - dst||^2, a proper rotation.

    CUDA tensors (float32, any N: shared memory up to MAX_POINTS, streamed
    above): ONE kernel launch on the current stream (no sync, output from
    `torch.empty`); raises if it does not build, load or launch.  CPU
    tensors: the plain version.
    """
    _check(src, dst, weights=weights)
    if src.device.type == "cpu":
        return rigid_fit_reference(src, dst, weights)
    lead, n = src.shape[:-2], src.shape[-2]
    s, d, w = _flat(src, n, 3), _flat(dst, n, 3), _flat(weights, n)
    b = s.shape[0]
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=src.device)
    if b:
        fit, _ = _launchers()
        _launched(fit(s.data_ptr(), d.data_ptr(), _ptr(w), out.data_ptr(), b,
                      n, torch.cuda.current_stream().cuda_stream), "rigid_fit")
    return out.reshape(lead + (4, 4))


def rigid_refit(src: Tensor, dst: Tensor, w1: Tensor, keep: Tensor,
                gate: Tensor | float) -> tuple[Tensor, Tensor, Tensor]:
    """The refit pair in one call: T1 = fit(w1); w2 = keep * [|T1 @ src -
    dst| < gate]; T2 = fit(w2).  src, dst (..., N, 3); w1, keep (..., N);
    gate (..., N) or a number.  Returns T2 (..., 4, 4), w2 (..., N) and the
    count of nonzero w2, (...) int32.

    CUDA tensors (float32, any N): ONE kernel launch on the current stream,
    T1 rounded to float32 between the fits as the two-call route hands it
    on; raises if it does not build, load or launch.  CPU tensors:
    the plain version.
    """
    if not (isinstance(w1, Tensor) and isinstance(keep, Tensor)):
        raise ValueError("w1 and keep must be (..., N) tensors")
    if not isinstance(gate, Tensor) and (isinstance(gate, bool)
                                         or not isinstance(gate, Real)):
        raise ValueError(f"gate must be a number or a (..., N) tensor, got "
                         f"{type(gate).__name__}")
    _check(src, dst, w1=w1, keep=keep,
           gate=gate if isinstance(gate, Tensor) else None)
    if src.device.type == "cpu":
        return rigid_refit_reference(src, dst, w1, keep, gate)
    lead, n = src.shape[:-2], src.shape[-2]
    s, d = _flat(src, n, 3), _flat(dst, n, 3)
    w, k = _flat(w1, n), _flat(keep, n)
    g = _flat(gate, n) if isinstance(gate, Tensor) else None
    gate_value = 0.0 if g is not None else float(gate)
    b = s.shape[0]
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=src.device)
    w2 = torch.empty((b, n), dtype=torch.float32, device=src.device)
    count = torch.empty((b,), dtype=torch.int32, device=src.device)
    if b:
        _, refit = _launchers()
        _launched(refit(s.data_ptr(), d.data_ptr(), w.data_ptr(), k.data_ptr(),
                        _ptr(g), gate_value, out.data_ptr(), w2.data_ptr(),
                        count.data_ptr(), b, n,
                        torch.cuda.current_stream().cuda_stream), "rigid_refit")
    return out.reshape(lead + (4, 4)), w2.reshape(lead + (n,)), count.reshape(lead)


rigid_fit.launches = 0
