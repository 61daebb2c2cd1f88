"""Grid non-max suppression + fixed-K keypoint selection.

Counterpart of `jetracer_orbslam2_tpu/ops/nms.py`: 3x3 local max with ties
kept, one winner per cell (first index on ties), and a fixed-K selection with
a validity mask.  `lax.top_k` returns equal scores lowest index first; empty
cells all score 0, so ties are the common case — selection here is a stable
descending sort sliced to K, which gives the same order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from jetracer_orbslam2_torch.utils.ties import first_argmax

Tensor = torch.Tensor


class CellWinners(NamedTuple):
    """Per-cell winner SoA."""

    score: Tensor  # (C,) float32, 0 where cell empty
    y: Tensor      # (C,) int32, level-local pixel row
    x: Tensor      # (C,) int32, level-local pixel col


class Keypoints(NamedTuple):
    """Fixed-K keypoint set with validity mask."""

    xy: Tensor        # (K, 2) float32 level-0 (x, y)
    xy_level: Tensor  # (K, 2) int32 level-local integer (x, y)
    level: Tensor     # (K,) int32 pyramid level
    score: Tensor     # (K,) float32
    valid: Tensor     # (K,) bool


def local_max_3x3(resp: Tensor) -> Tensor:
    """Keep responses that are >= all 8 neighbours (ties kept).  Outside the
    map counts as 0; responses are >= 0 with a zero border band, so this
    equals the JAX oracle's wrap-around version."""
    h, w = resp.shape
    pad = F.pad(resp, (1, 1, 1, 1))
    neighborhood = resp
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neighborhood = torch.maximum(
                neighborhood, pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return torch.where(resp >= neighborhood, resp, torch.zeros_like(resp))


def grid_nms(resp: Tensor, cell_size: int, suppress: bool = True) -> CellWinners:
    """One winner per cell_size x cell_size cell of a response map.

    resp: (H, W) float32, zeros at non-corners.  Returns flat (C,) winners,
    C = ceil(H/cell) * ceil(W/cell).  Pass suppress=False when the map is
    already 3x3-suppressed (ops/fused_fast.fast_nms_response does it).
    """
    if suppress:
        resp = local_max_3x3(resp)
    h, w = resp.shape
    rows = -(-h // cell_size)
    cols = -(-w // cell_size)
    ph, pw = rows * cell_size - h, cols * cell_size - w
    if ph or pw:
        resp = F.pad(resp, (0, pw, 0, ph))
    cells = resp.reshape(rows, cell_size, cols, cell_size)
    cells = cells.permute(0, 2, 1, 3).reshape(rows, cols, cell_size * cell_size)
    score, idx = first_argmax(cells, -1)
    idx = idx.to(torch.int32)
    cy = torch.arange(rows, dtype=torch.int32, device=resp.device)[:, None] * cell_size
    cx = torch.arange(cols, dtype=torch.int32, device=resp.device)[None, :] * cell_size
    y = cy + idx // cell_size
    x = cx + idx % cell_size
    return CellWinners(score.reshape(-1), y.reshape(-1), x.reshape(-1))


def select_keypoints(
    winners: Sequence[CellWinners],
    level_shapes: Sequence[Tuple[int, int]],
    max_keypoints: int,
    min_score: float,
    border: int,
) -> Keypoints:
    """Concatenate per-level cell winners, map to level-0 coords, take top-K.

    `border` is enforced again here as a level-local keep-out, so the
    contract holds for any response source.
    """
    scores, xs, ys, levels = [], [], [], []
    for lvl, cw in enumerate(winners):
        scale = float(2 ** lvl)
        h, w = level_shapes[lvl]
        in_bounds = ((cw.x >= border) & (cw.x < w - border)
                     & (cw.y >= border) & (cw.y < h - border))
        # center-of-pixel mapping through repeated 2x2 box halfsampling
        xs.append((cw.x.to(torch.float32) + 0.5) * scale - 0.5)
        ys.append((cw.y.to(torch.float32) + 0.5) * scale - 0.5)
        scores.append(torch.where(in_bounds, cw.score,
                                  torch.zeros_like(cw.score)))
        levels.append(torch.full_like(cw.x, lvl, dtype=torch.int32))
    score = torch.cat(scores)
    x = torch.cat(xs)
    y = torch.cat(ys)
    level = torch.cat(levels)
    xl = torch.cat([cw.x for cw in winners])
    yl = torch.cat([cw.y for cw in winners])

    k = min(max_keypoints, score.shape[0])
    order = torch.sort(score, descending=True, stable=True)
    top_score, top_idx = order.values[:k], order.indices[:k]
    if k < max_keypoints:
        pad = max_keypoints - k
        top_score = F.pad(top_score, (0, pad))
        top_idx = F.pad(top_idx, (0, pad))
    valid = top_score > min_score

    return Keypoints(
        xy=torch.stack([x[top_idx], y[top_idx]], -1),
        xy_level=torch.stack([xl[top_idx], yl[top_idx]], -1).to(torch.int32),
        level=level[top_idx],
        score=top_score,
        valid=valid,
    )
