"""Linear algebra the port's captured frame step can hold.

`cholesky_solve(b, L)` is `torch.cholesky_solve(b, L)` for a lower factor,
made of its two triangular solves (`torch.linalg.solve_triangular`, cuBLAS
on the card).  On the card `torch.cholesky_solve` is cuSOLVER's potrs, which
allocates stream-ordered memory: captured into a CUDA graph those are memory
nodes, and the body of a conditional node may hold none, so the keyframe
branch of `models/slam_scan.py`'s frame graph (windowed BA, the pose graph)
could not be captured with it.  The factorisation itself
(`torch.linalg.cholesky_ex`, cuSOLVER's potrf) allocates nothing.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def cholesky_solve(b: Tensor, L: Tensor) -> Tensor:
    """x with L L^T x = b, for the lower Cholesky factor L (..., n, n) and b
    (..., n, k)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)
