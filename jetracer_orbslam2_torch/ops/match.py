"""Descriptor matching: batched Hamming distance + gated best-match selection.

Counterpart of `jetracer_orbslam2_tpu/ops/match.py`.  The K x K Hamming
matrix is the same +-1 contraction (dot = bits - 2*hamming), in float32:
every value is a small integer, so the product is exact with TF32 off
(utils/precision.py) and equals XOR + popcount.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jetracer_orbslam2_torch.ops.orb import unpack_bits
from jetracer_orbslam2_torch.utils.ties import first_argmin

Tensor = torch.Tensor

_BIG = 1e9


class Matches(NamedTuple):
    idx: Tensor    # (Ka,) int32 index into B for each A keypoint
    dist: Tensor   # (Ka,) float32 Hamming distance of best match
    valid: Tensor  # (Ka,) bool


def hamming_matrix(desc_a: Tensor, desc_b: Tensor, num_bits: int = 256) -> Tensor:
    """(Ka, W) x (Kb, W) packed int32 -> (Ka, Kb) float32 Hamming distances."""
    a = unpack_bits(desc_a, num_bits) * 2.0 - 1.0
    b = unpack_bits(desc_b, num_bits) * 2.0 - 1.0
    return (num_bits - a @ b.T) * 0.5


def match(
    desc_a: Tensor,
    desc_b: Tensor,
    valid_a: Tensor,
    valid_b: Tensor,
    xy_a_pred: Tensor | None = None,
    xy_b: Tensor | None = None,
    window: float = 0.0,
    max_hamming: float = 64.0,
    ratio: float = 1.0,
    mutual: bool = True,
    num_bits: int = 256,
) -> Matches:
    """Gated best-match selection A -> B.

    xy_a_pred: (Ka, 2) predicted pixel position of each A keypoint in B's
    frame; xy_b: (Kb, 2) B keypoint positions.  window > 0 enables the
    reprojection gate.  Ties go to the lowest index, as in the JAX package.
    """
    d = hamming_matrix(desc_a, desc_b, num_bits)          # (Ka, Kb)
    gate = (~valid_a[:, None]) | (~valid_b[None, :])
    if window > 0.0 and xy_a_pred is not None and xy_b is not None:
        dx = xy_a_pred[:, None, 0] - xy_b[None, :, 0]
        dy = xy_a_pred[:, None, 1] - xy_b[None, :, 1]
        gate = gate | (torch.abs(dx) > window) | (torch.abs(dy) > window)
    d = d.masked_fill(gate, _BIG)

    best_d, best_j = first_argmin(d, 1)
    ka, kb = d.shape
    cols = torch.arange(kb, device=d.device)
    d_wo_best = d.masked_fill(cols[None, :] == best_j[:, None], _BIG)
    second_d = d_wo_best.amin(dim=1)

    ok = (best_d <= max_hamming) & valid_a
    if ratio < 1.0:
        ok = ok & (best_d <= ratio * second_d)
    if mutual:
        _, best_i_for_b = first_argmin(d, 0)              # (Kb,)
        rows = torch.arange(ka, device=d.device)
        ok = ok & (best_i_for_b[best_j] == rows)
    return Matches(idx=best_j.to(torch.int32), dist=best_d, valid=ok)
