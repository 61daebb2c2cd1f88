"""Fused BA normal equations + Schur preparation, and the landmark
back-substitution: the hand-written CUDA kernels' wrappers, with their plain
PyTorch versions beside them.

Counterpart of `jetracer_orbslam2_tpu/ops/pallas_ba.py` (`fused_normal_schur`
and `fused_backsub`, two Pallas kernels).  The CUDA source is
`jetracer_orbslam2_torch/csrc/ba_fused.cu`; its header describes the design.
`fused_normal_schur` is a persistent split-K over landmarks: at most two
blocks an SM walk tiles of 32 landmarks (the next tile's observations copied
into shared memory while the current one is reduced), keep their Hpp/bp and
S/rhs sums in registers across tiles (the upper triangle of S only), and
write ONE partial per block; a second, wide kernel adds the partials in
block order.  `fused_backsub` runs a thread per (pose, landmark): 32
landmarks x 8 pose warps a block stage each slot's Jl and Jp dxp, and one
thread a landmark folds them in pose order.  Jacobians live in registers
and shared memory only.

What the port's kernels return differs from the TPU kernels' in layout only:
`Hpp` comes as its (P, 6, 6) diagonal blocks (the TPU kernel returns the full
48 x 48 Jp Jp^T because its matrix unit makes it free) and `S = Gh G^T` in
pose-major order (row p*6 + i), so the caller has nothing to un-interleave.
Any 1 <= P <= MAX_POSES and any L >= 1; no padding.

Bound on the card: `fused_normal_schur` by operations (one triangle of the
(6n) x (6n+1) x 3 product per landmark and its n observing poses: 117.3 M
f32 operations = 1.75 us at P 8, L 16,384), `fused_backsub` by bytes;
`chip_smoke.py` counts both per shape.  The kernels' sums are FP32 FMAs in a
fixed order and no float atomic is used: two launches on the same inputs
agree bit for bit, and both agree with the plain versions to rounding (a
stated tolerance, not bit for bit).

Each wrapper launches its kernel for a CUDA tensor or raises; it runs the
plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from jetracer_orbslam2_torch.models.backend import ba
from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.step_graph import note_launch

Tensor = torch.Tensor

_LIB_NAME = "ba_fused"
# The kernels' cap on the pose count: ba_assemble stages three (6P)-row
# operands of 3 x 32 columns and two tiles of observations in shared memory,
# 153 KB at P = 16 of the 227 KB a block may use.  Must equal MAX_POSES in
# csrc/ba_fused.cu.
MAX_POSES = 16


def takes_num_poses(num_poses: int) -> bool:
    return 1 <= num_poses <= MAX_POSES


def _launchers():
    lib = cuda_build.load_library(_LIB_NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if lib.ba_assemble_launch.argtypes is None:
        lib.ba_assemble_launch.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 8
        lib.ba_assemble_launch.restype = i32
        lib.ba_backsub_launch.argtypes = [ptr] * 8 + [i32, i32, ptr, ptr]
        lib.ba_backsub_launch.restype = i32
        lib.ba_workspace_floats.argtypes = [i32, i32]
        lib.ba_workspace_floats.restype = ctypes.c_longlong
        lib.ba_max_poses.restype = i32
        if lib.ba_max_poses() != MAX_POSES:
            raise RuntimeError("MAX_POSES differs between ops/fused_ba.py "
                               "and csrc/ba_fused.cu")
    return lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _unpack(poses_flat: Tensor, obs: Tensor, scalars: Tensor):
    P = poses_flat.shape[0]
    poses_cw = torch.cat([poses_flat[:, :9].reshape(P, 3, 3),
                          poses_flat[:, 9:12, None]], -1)        # (P, 3, 4)
    dense = ba.DenseObs(uv=obs[:2], z=obs[2], z_valid=obs[3] > 0.5, w=obs[4])
    return poses_cw, dense, scalars[0, :4], scalars[0, 4], scalars[0, 5]


def fused_normal_schur_reference(poses_flat: Tensor, points: Tensor,
                                 obs: Tensor, lm_free: Tensor,
                                 scalars: Tensor):
    """Plain version of `fused_normal_schur`: same arguments, same outputs
    in the same layout, from `ba.dense_normal_equations` and the pieces of
    `ba._solve_schur`.  Runs in the dtype of its inputs (float64 inputs give
    the truth the card check measures both float32 versions against)."""
    poses_cw, dense, intr, lam, huber = _unpack(poses_flat, obs, scalars)
    Hpp, Hll, G, bp, bl, _ = ba.dense_normal_equations(
        poses_cw, points, dense, dense.w, intr, huber)
    hll_inv = ba._damped_hll_inverse(Hll, lam, lm_free[0])
    GhG, rhs_gh = ba._schur_products(G, hll_inv, bl)
    return tuple(x.contiguous() for x in (
        Hpp, GhG, bp, rhs_gh, hll_inv.reshape(9, -1), bl))


def fused_backsub_reference(poses_flat: Tensor, points: Tensor, obs: Tensor,
                            lm_free: Tensor, scalars: Tensor,
                            hll_inv: Tensor, bl: Tensor,
                            dxp: Tensor) -> Tensor:
    """Plain version of `fused_backsub`: dxl (3, L) = lm_free * Hll^-1
    (bl - G^T dxp), with G recomputed from the weighted Jacobians."""
    poses_cw, dense, intr, _, huber = _unpack(poses_flat, obs, scalars)
    P, L = poses_flat.shape[0], points.shape[-1]
    _, _, G, _, _, _ = ba.dense_normal_equations(
        poses_cw, points, dense, dense.w, intr, huber)
    Gt_dxp = (dxp.reshape(1, P * 6) @ G.reshape(P * 6, 3 * L)).reshape(3, L)
    resid = bl - Gt_dxp
    dxl = torch.sum(hll_inv.reshape(3, 3, L) * resid[:, None], dim=0)
    return (dxl * lm_free).contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(named: dict) -> tuple[int, int, torch.device]:
    """Type, layout, shape and device checks shared by both wrappers;
    returns (P, L, device)."""
    poses_flat = named["poses_flat"]
    for name, x in named.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != poses_flat.device:
            raise ValueError(f"{name} lies on {x.device}, poses_flat on "
                             f"{poses_flat.device}")
    if poses_flat.dim() != 2 or poses_flat.shape[1] != 12:
        raise ValueError("poses_flat must be (P, 12), got "
                         f"{tuple(poses_flat.shape)}")
    P = poses_flat.shape[0]
    if not takes_num_poses(P):
        raise ValueError(f"the fused BA kernels take 1..{MAX_POSES} poses, "
                         f"got {P}")
    points = named["points"]
    if points.dim() != 2 or points.shape[0] != 3 or points.shape[1] < 1:
        raise ValueError(f"points must be (3, L>=1), got {tuple(points.shape)}")
    L = points.shape[1]
    want = {"obs": (5, P, L), "lm_free": (1, L), "scalars": (1, 8),
            "hll_inv": (9, L), "bl": (3, L), "dxp": (P, 6)}
    for name, shape in want.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(named[name].shape)}")
    dev = poses_flat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"the tensors live on {dev}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    return P, L, dev


def fused_normal_schur(poses_flat: Tensor, points: Tensor, obs: Tensor,
                       lm_free: Tensor, scalars: Tensor):
    """One fused pass over the landmarks.

    poses_flat (P, 12) [R row-major | t] of T_cw; points (3, L); obs
    (5, P, L) [u, v, z, z_valid, w]; lm_free (1, L); scalars (1, 8)
    [fx, fy, cx, cy, lambda, huber, 0, 0]; all float32 and contiguous.

    Returns (Hpp (P,6,6), GhG (6P,6P) = Gh G^T pose-major, bp (P,6),
    rhs_gh (P,6) = Gh bl, Hll^-1 (9,L), bl (3,L)).  The Schur complement is
    damped Hpp (block diagonal) - GhG.

    CUDA tensors: launches the kernels (the persistent pass and the
    reduction of its partials) on the current stream (no sync, outputs and
    workspace from `torch.empty`) and raises if they do not build, load or
    launch.  CPU tensors: the plain version.
    """
    P, L, dev = _check(dict(poses_flat=poses_flat, points=points, obs=obs,
                            lm_free=lm_free, scalars=scalars))
    if dev.type == "cpu":
        return fused_normal_schur_reference(poses_flat, points, obs, lm_free,
                                            scalars)
    lib = _launchers()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    Hpp, GhG = new(P, 6, 6), new(6 * P, 6 * P)
    bp, rhs_gh = new(P, 6), new(P, 6)
    hll_inv, bl = new(9, L), new(3, L)
    n_work = lib.ba_workspace_floats(P, L)
    if n_work < 0:
        raise RuntimeError("ba_assemble: the CUDA device could not be queried")
    work = new(n_work)
    err = lib.ba_assemble_launch(
        poses_flat.data_ptr(), points.data_ptr(), obs.data_ptr(),
        lm_free.data_ptr(), scalars.data_ptr(), P, L, work.data_ptr(),
        Hpp.data_ptr(), GhG.data_ptr(), bp.data_ptr(), rhs_gh.data_ptr(),
        hll_inv.data_ptr(), bl.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ba_assemble kernel launch failed: cudaError {err}")
    note_launch(fused_normal_schur)
    return Hpp, GhG, bp, rhs_gh, hll_inv, bl


def fused_backsub(poses_flat: Tensor, points: Tensor, obs: Tensor,
                  lm_free: Tensor, scalars: Tensor, hll_inv: Tensor,
                  bl: Tensor, dxp: Tensor) -> Tensor:
    """dxl (3, L) = lm_free * Hll^-1 (bl - G^T dxp); the weighted Jacobians
    are recomputed per landmark.  Arguments as `fused_normal_schur`, plus its
    outputs hll_inv (9, L) and bl (3, L), and dxp (P, 6).  Device rule as
    `fused_normal_schur`."""
    P, L, dev = _check(dict(poses_flat=poses_flat, points=points, obs=obs,
                            lm_free=lm_free, scalars=scalars,
                            hll_inv=hll_inv, bl=bl, dxp=dxp))
    if dev.type == "cpu":
        return fused_backsub_reference(poses_flat, points, obs, lm_free,
                                       scalars, hll_inv, bl, dxp)
    lib = _launchers()
    dxl = torch.empty((3, L), dtype=torch.float32, device=dev)
    err = lib.ba_backsub_launch(
        poses_flat.data_ptr(), points.data_ptr(), obs.data_ptr(),
        lm_free.data_ptr(), scalars.data_ptr(), hll_inv.data_ptr(),
        bl.data_ptr(), dxp.data_ptr(), P, L, dxl.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ba_backsub kernel launch failed: cudaError {err}")
    note_launch(fused_backsub)
    return dxl


fused_normal_schur.launches = 0
fused_backsub.launches = 0
