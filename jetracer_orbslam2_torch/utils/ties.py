"""Arg-reductions with a defined tie order.

`jnp.argmax`/`jnp.argmin` return the FIRST index attaining the extremum, and
the JAX package leans on that (all-zero NMS cells, fully gated match rows,
degenerate RANSAC hypotheses).  `torch.argmax`/`torch.argmin` document no tie
order, so the port computes the first index explicitly.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _first_index_of(x: Tensor, best: Tensor, dim: int) -> Tensor:
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    hit = x == best.unsqueeze(dim)
    return torch.where(hit, pos, n).amin(dim=dim)


def first_argmax(x: Tensor, dim: int = -1) -> tuple[Tensor, Tensor]:
    """(max, first index attaining it) along `dim` (int64 indices)."""
    dim = dim % x.dim()
    best = x.amax(dim=dim)
    return best, _first_index_of(x, best, dim)


def first_argmin(x: Tensor, dim: int = -1) -> tuple[Tensor, Tensor]:
    """(min, first index attaining it) along `dim` (int64 indices)."""
    dim = dim % x.dim()
    best = x.amin(dim=dim)
    return best, _first_index_of(x, best, dim)
