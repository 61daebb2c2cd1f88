"""RANSAC's hypotheses, their scores and the winner through the hand-written
CUDA kernel K7, with its plain PyTorch version beside it.

`ransac_select(src, dst, keep, sample_idx, tz)` is the part of
`tracking.ransac_kabsch` between the draw and the refit: a quaternion Kabsch
fit (`geometry.kabsch_quat`) on each drawn triple, the inlier count of each
fit over every pair (`|R src + t - dst| < tz` where `keep > 0`), the first
hypothesis of the largest count, and its inlier mask w1, which the refit
pair (`fused_rigid.rigid_refit`, K5) starts from.

The plain version is that code as it was: about 420 small kernels a call on
the card (the batched quaternion Kabsch's 30 Newton steps are most of them).
The kernel, `jetracer_orbslam2_torch/csrc/ransac_hyp.cu`, does it in one
launch: a problem split over a thread-block cluster of up to 16 blocks (by
H; a non-portable cluster above 8), one thread a hypothesis solving the
plain version's f32 algebra step for step, the points copied into shared
memory once (any larger K read from memory), integer counts, and the winner
agreed through distributed shared memory (no float atomics, so a relaunch and a graph replay give the same
bits).  It replaces no TPU kernel: the JAX package's counterpart is a few
ops inside its jitted frame step
(`jetracer_orbslam2_tpu/models/tracking.py:108-150`), which XLA fuses.

Bound on the card: latency (a launch, one serial solve, the tests, one
reduction); at B = 1, H = 256, K = 1,024 it moves 43 KB and does about
7.4 M f32 operations, 0.11 us of the card's peak (`chip_smoke.py`'s
`_k7_bounds`).
"""

from __future__ import annotations

import ctypes

import torch

from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.step_graph import note_launch
from jetracer_orbslam2_torch.utils.ties import first_argmax

Tensor = torch.Tensor

_LIB_NAME = "ransac_hyp"

_ptrs: dict[str, object] = {}


def _launcher():
    """ransac_hyp_launch, the library built and set up (the staged kernel
    allowed its shared memory) at the first call."""
    if not _ptrs:
        lib = cuda_build.load_library(_LIB_NAME)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.ransac_hyp_launch
        fn.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
        fn.restype = lib.ransac_hyp_setup.restype = i32
        err = lib.ransac_hyp_setup()
        if err != 0:
            raise RuntimeError(f"ransac_hyp setup failed: cudaError {err}")
        _ptrs["select"] = fn
    return _ptrs["select"]


def _select_one(src: Tensor, dst: Tensor, keep: Tensor, sample_idx: Tensor,
                tz: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """One problem: src, dst (K, 3), keep, tz (K,), sample_idx (H, 3)."""
    s = src[sample_idx]                      # (H, 3, 3)
    d = dst[sample_idx]
    T_h = geo.kabsch_quat(s, d)              # (H, 4, 4)
    # score all hypotheses against all correspondences
    src_t = src[None] @ T_h[:, :3, :3].transpose(-1, -2) + T_h[:, None, :3, 3]
    err = torch.linalg.norm(src_t - dst[None], dim=-1)         # (H, K)
    inl = (err < tz[None]) & (keep > 0)
    score = torch.sum(inl, dim=1)
    _, best = first_argmax(score, 0)
    # index_select, not inl[best]: indexing with a 0-dim tensor reads it
    # back to the host
    w1 = inl.index_select(0, best.reshape(1))[0].to(src.dtype)
    return best, score.index_select(0, best.reshape(1))[0].to(torch.int32), w1


def ransac_select_reference(src: Tensor, dst: Tensor, keep: Tensor,
                            sample_idx: Tensor, tz: Tensor
                            ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version: one problem ((K, 3) src, dst; (K,) keep, tz; (H, 3)
    sample_idx) or a batch (a leading B on each), a loop over the batch.
    Used on CPU tensors and as the yardstick the kernel is held against on
    the card."""
    if src.dim() == 2:
        return _select_one(src, dst, keep, sample_idx, tz)
    rows = [_select_one(src[i], dst[i], keep[i], sample_idx[i], tz[i])
            for i in range(src.shape[0])]
    if not rows:
        k = src.shape[1]
        return (torch.zeros(0, dtype=torch.int64, device=src.device),
                torch.zeros(0, dtype=torch.int32, device=src.device),
                src.new_zeros((0, k)))
    return tuple(torch.stack(x) for x in zip(*rows))


def _check(src, dst, keep, sample_idx, tz) -> None:
    """Shapes: src, dst (..., K, 3), keep and tz (..., K), sample_idx (..., H,
    3) with one leading B or none, K >= 1, H >= 1; all on src's device,
    float32 (sample_idx int64) on the card, the card the current CUDA
    device; sample_idx an integer tensor."""
    tensors = {"src": src, "dst": dst, "keep": keep, "sample_idx": sample_idx,
               "tz": tz}
    for name, v in tensors.items():
        if not isinstance(v, Tensor):
            raise ValueError(f"{name} must be a tensor, got {type(v).__name__}")
    if src.dim() not in (2, 3) or src.shape[-1] != 3 or src.shape[-2] < 1:
        raise ValueError(f"src must be (K, 3) or (B, K, 3) with K >= 1, got "
                         f"{tuple(src.shape)}")
    lead, k = tuple(src.shape[:-2]), src.shape[-2]
    if (sample_idx.dim() != src.dim() or tuple(sample_idx.shape[:-2]) != lead
            or sample_idx.shape[-1] != 3 or sample_idx.shape[-2] < 1):
        raise ValueError(f"sample_idx must be {lead + ('H', 3)} with H >= 1, "
                         f"got {tuple(sample_idx.shape)}")
    want = {"dst": lead + (k, 3), "keep": lead + (k,), "tz": lead + (k,)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    if sample_idx.dtype.is_floating_point or sample_idx.dtype.is_complex \
            or sample_idx.dtype == torch.bool:
        raise TypeError(f"sample_idx must be an integer tensor, got "
                        f"{sample_idx.dtype}")
    for name, v in tensors.items():
        if v.device != src.device:
            raise ValueError(f"{name} lies on {v.device}, src on {src.device}")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src.device}")
    if src.device.type == "cuda":
        for name, v in tensors.items():
            want_dtype = torch.int64 if name == "sample_idx" else torch.float32
            if v.dtype != want_dtype:
                raise TypeError(f"{name} must be {want_dtype} on the card, got "
                                f"{v.dtype}")
        if src.device.index != torch.cuda.current_device():
            raise ValueError(f"src lives on {src.device}, the current CUDA "
                             f"device is {torch.cuda.current_device()}")


def ransac_select(src: Tensor, dst: Tensor, keep: Tensor, sample_idx: Tensor,
                  tz: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The winner of RANSAC's hypotheses, one problem or a batch (see
    `ransac_select_reference`): (best, the first index of the largest
    inlier count, int64; that count, int32; its inlier mask w1, src's
    dtype), best and the count of src's leading shape.

    CUDA tensors (float32, sample_idx int64, any K and H): ONE kernel launch
    on the current stream (no sync, outputs from `torch.empty`); raises if
    the kernel does not build, load or launch.  CPU tensors: the plain
    version.
    """
    _check(src, dst, keep, sample_idx, tz)
    if src.device.type == "cpu":
        return ransac_select_reference(src, dst, keep, sample_idx, tz)
    lead, k, h = src.shape[:-2], src.shape[-2], sample_idx.shape[-2]
    b = 1 if src.dim() == 2 else src.shape[0]
    s, d = (x.reshape(b, k, 3).contiguous() for x in (src, dst))
    kp, t = (x.reshape(b, k).contiguous() for x in (keep, tz))
    idx = sample_idx.reshape(b, h, 3).contiguous()
    best = torch.empty((b,), dtype=torch.int64, device=src.device)
    score = torch.empty((b,), dtype=torch.int32, device=src.device)
    w1 = torch.empty((b, k), dtype=torch.float32, device=src.device)
    if b:
        err = _launcher()(s.data_ptr(), d.data_ptr(), kp.data_ptr(),
                          idx.data_ptr(), t.data_ptr(), best.data_ptr(),
                          score.data_ptr(), w1.data_ptr(), b, k, h,
                          torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ransac_hyp kernel launch failed: cudaError {err}")
        note_launch(ransac_select)
    return best.reshape(lead), score.reshape(lead), w1.reshape(lead + (k,))


ransac_select.launches = 0
