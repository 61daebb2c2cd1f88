"""Motion-only reprojection polish through the hand-written CUDA kernel K6,
with its plain PyTorch version beside it.

`pose_polish(T0, X_src, uv_dst, z_dst, w, intrinsics, iters, huber_px)`
refines T (dst <- src) by `iters` Gauss-Newton steps so that the 3D points
X_src project onto their measured pixels uv_dst (plus a depth row where
z_dst > 0), with IRLS Huber weights: `tracking.refine_pose_reprojection`,
which the tracker's polish and the SLAM map polish call.

The plain version is that function's body as it was: per step a projection,
the residuals, the Huber weights, (K, 3, 6) Jacobians, two einsums into a
6 x 6 system, `torch.linalg.solve_ex` and `se3_exp`, about 515 small
kernels a call on the card.  The kernel, `jetracer_orbslam2_torch/csrc/
pose_polish.cu`, runs every step in one launch: one block a problem, the
points in registers (K <= 1,024) or read from memory each step (any larger
K), the 27 sums of H and b in f64 in one fixed-order reduction (no atomics,
so a relaunch and a graph replay give the same bits), a 6 x 6 Cholesky by one
thread, se3_exp in f32.  It replaces no TPU kernel: the JAX package's
counterpart is one `lax.scan` inside its jitted frame step
(`jetracer_orbslam2_tpu/models/tracking.py:59-105`), which XLA fuses.

Bound on the card: latency (a launch, then per step a pass over the
points, a block reduction and a serial factorisation); at B = 1, K = 1,024
it reads 28 KB.
"""

from __future__ import annotations

import ctypes
from numbers import Real

import torch

from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.step_graph import note_launch

Tensor = torch.Tensor

_LIB_NAME = "pose_polish"

_ptrs: dict[str, object] = {}


def _launcher():
    """pose_polish_launch, the library built and loaded at the first call."""
    if not _ptrs:
        lib = cuda_build.load_library(_LIB_NAME)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.pose_polish_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                       ctypes.c_float, ptr]
        fn.restype = i32
        _ptrs["polish"] = fn
    return _ptrs["polish"]


def _polish_one(T0: Tensor, X_src: Tensor, uv_dst: Tensor, z_dst: Tensor,
                w: Tensor, intrinsics: Tensor, iters: int,
                huber_px: float) -> Tensor:
    """One problem: T0 (4, 4), X_src (K, 3), uv_dst (K, 2), z_dst, w (K,)."""
    fx, fy = intrinsics[0], intrinsics[1]
    zero = torch.zeros_like(z_dst)
    wz_row = torch.where(z_dst > 1e-3, fx / torch.clamp_min(z_dst, 0.1), zero)
    eye3 = torch.eye(3, dtype=X_src.dtype, device=X_src.device)
    eye6 = torch.eye(6, dtype=X_src.dtype, device=X_src.device)
    I3 = eye3.expand(X_src.shape[0], 3, 3)

    T = T0
    for _ in range(iters):
        p = geo.transform_points(T, X_src[None])[0]        # (K, 3)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        iz = 1.0 / torch.clamp_min(z, 1e-6)
        u = fx * x * iz + intrinsics[2]
        v = fy * y * iz + intrinsics[3]
        r = torch.stack([u - uv_dst[:, 0], v - uv_dst[:, 1],
                         wz_row * (z - z_dst)], -1)        # (K, 3)
        wk = w * (z > 1e-3)
        # IRLS Huber on the pixel norm
        n = torch.linalg.norm(r, dim=-1)
        wk = wk * torch.clamp_max(huber_px / torch.clamp_min(n, 1e-9), 1.0)
        J_proj = torch.stack([
            torch.stack([fx * iz, zero, -fx * x * iz * iz], -1),
            torch.stack([zero, fy * iz, -fy * y * iz * iz], -1),
            torch.stack([zero, zero, wz_row], -1),
        ], 1)                                              # (K, 3, 3)
        J_pose = torch.cat([I3, -geo.hat(p)], -1)          # (K, 3, 6)
        J = J_proj @ J_pose                                # (K, 3, 6)
        Jw = J * wk[:, None, None]
        H = torch.einsum("kri,krj->ij", Jw, J) + 1e-6 * eye6
        b = -torch.einsum("kri,kr->i", Jw, r)
        # solve_ex: no error check, so no host sync inside the frame loop
        dx = torch.linalg.solve_ex(H, b).result
        T = geo.se3_exp(dx) @ T
    return T


def pose_polish_reference(T0: Tensor, X_src: Tensor, uv_dst: Tensor,
                          z_dst: Tensor, w: Tensor, intrinsics: Tensor,
                          iters: int = 5, huber_px: float = 2.0) -> Tensor:
    """Plain version: motion-only Gauss-Newton with IRLS Huber weights, one
    problem ((4, 4) T0, (K, ...) points) or a batch ((B, 4, 4), (B, K, ...)),
    a loop over the batch.  Used on CPU tensors and as the yardstick the
    kernel is held against on the card."""
    if T0.dim() == 2:
        return _polish_one(T0, X_src, uv_dst, z_dst, w, intrinsics, iters,
                           huber_px)
    return torch.stack([
        _polish_one(T0[i], X_src[i], uv_dst[i], z_dst[i], w[i], intrinsics,
                    iters, huber_px) for i in range(T0.shape[0])])


def _check(T0, X_src, uv_dst, z_dst, w, intrinsics, iters, huber_px,
           singular) -> None:
    """Shapes: T0 (4, 4) or (B, 4, 4); X_src (..., K, 3), uv_dst (..., K, 2),
    z_dst and w (..., K) with T0's leading dimension; intrinsics (4,); all
    tensors on T0's device, float32 on the card, the card the current CUDA
    device; iters a non-negative int, huber_px a number; `singular`, only on
    the card, None or an int32 tensor of T0's leading shape."""
    tensors = {"T0": T0, "X_src": X_src, "uv_dst": uv_dst, "z_dst": z_dst,
               "w": w, "intrinsics": intrinsics}
    for name, v in tensors.items():
        if not isinstance(v, Tensor):
            raise ValueError(f"{name} must be a tensor, got {type(v).__name__}")
    if T0.dim() not in (2, 3) or T0.shape[-2:] != (4, 4):
        raise ValueError(f"T0 must be (4, 4) or (B, 4, 4), got {tuple(T0.shape)}")
    lead = tuple(T0.shape[:-2])
    if X_src.dim() != T0.dim() or X_src.shape[:-2] != lead or X_src.shape[-1] != 3:
        raise ValueError(f"X_src must be {lead + ('K', 3)}, got {tuple(X_src.shape)}")
    k = X_src.shape[-2]
    want = {"uv_dst": lead + (k, 2), "z_dst": lead + (k,), "w": lead + (k,),
            "intrinsics": (4,)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    if isinstance(iters, bool) or not isinstance(iters, int) or iters < 0:
        raise ValueError(f"iters must be a non-negative int, got {iters!r}")
    if isinstance(huber_px, bool) or not isinstance(huber_px, Real):
        raise ValueError(f"huber_px must be a number, got "
                         f"{type(huber_px).__name__}")
    for name, v in tensors.items():
        if v.device != T0.device:
            raise ValueError(f"{name} lies on {v.device}, T0 on {T0.device}")
        if v.device.type == "cuda" and v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {v.dtype}")
    if T0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {T0.device}")
    if singular is not None:
        if T0.device.type != "cuda":
            raise ValueError("singular counts the kernel's steps: the card only")
        if (not isinstance(singular, Tensor) or singular.dtype != torch.int32
                or tuple(singular.shape) != lead
                or singular.device != T0.device or not singular.is_contiguous()):
            raise ValueError(f"singular must be a contiguous int32 tensor of "
                             f"shape {lead} on {T0.device}")
    if T0.device.type == "cuda" and T0.device.index != torch.cuda.current_device():
        raise ValueError(f"T0 lives on {T0.device}, the current CUDA device is "
                         f"{torch.cuda.current_device()}")


def pose_polish(T0: Tensor, X_src: Tensor, uv_dst: Tensor, z_dst: Tensor,
                w: Tensor, intrinsics: Tensor, iters: int = 5,
                huber_px: float = 2.0, singular: Tensor | None = None) -> Tensor:
    """`iters` Gauss-Newton steps on T0 (dst <- src), one problem or a
    batch (see `pose_polish_reference`); returns T of T0's shape.

    CUDA tensors (float32, any K): ONE kernel launch on the current stream
    (no sync, the intrinsics read on the card, output from `torch.empty`);
    `singular`, when given, receives each problem's count of steps whose
    Cholesky met a pivot that was not positive (dx = 0 there).  Raises if the
    kernel does not build, load or launch.  CPU tensors: the plain version.
    """
    _check(T0, X_src, uv_dst, z_dst, w, intrinsics, iters, huber_px, singular)
    if T0.device.type == "cpu":
        return pose_polish_reference(T0, X_src, uv_dst, z_dst, w, intrinsics,
                                     iters, huber_px)
    lead, k = T0.shape[:-2], X_src.shape[-2]
    b = 1 if T0.dim() == 2 else T0.shape[0]
    flat = [x.reshape((b,) + tuple(x.shape[len(lead):])).contiguous()
            for x in (T0, X_src, uv_dst, z_dst, w)]
    intr = intrinsics.contiguous()
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=T0.device)
    if b:
        err = _launcher()(*(x.data_ptr() for x in flat), intr.data_ptr(),
                          out.data_ptr(),
                          None if singular is None else singular.data_ptr(),
                          b, k, iters, float(huber_px),
                          torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"pose_polish kernel launch failed: cudaError {err}")
        note_launch(pose_polish)
    return out.reshape(lead + (4, 4))


pose_polish.launches = 0
