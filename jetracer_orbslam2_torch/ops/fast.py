"""FAST corner response in plain PyTorch (whole image, branchless).

Counterpart of `jetracer_orbslam2_tpu/ops/fast.py`, and the plain version the
hand-written kernel (`fused_fast.py`, `csrc/fast_nms.cu`) is held against.
The 16 ring terms are accumulated one after the other, i = 0..15, in float32
— the order the CUDA kernel uses — so the two agree bit for bit on any input.

Outside the image reads as 0 (the JAX oracle wraps around instead); for
`border >= 3` the ring of every pixel that survives the keep-out band lies
inside the image, so both are the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _rot16(m: Tensor, k: int) -> Tensor:
    """Rotate the low 16 bits of int32 lanes right by k (bit i <- bit i+k)."""
    k %= 16
    if k == 0:
        return m
    return ((m >> k) | (m << (16 - k))) & 0xFFFF


def has_arc(mask: Tensor, length: int) -> Tensor:
    """True where the 16-bit ring mask holds a circular run of >= `length`
    set bits.  Run-length doubling: bit i of p[n] says ring bits i..i+n-1
    are all set; `length` is composed from powers of two."""
    if not 1 <= length <= 16:
        raise ValueError("arc length must be in 1..16")
    p = {1: mask}
    k = 1
    while k < 16:
        p[2 * k] = p[k] & _rot16(p[k], k)
        k *= 2
    run = None
    offset = 0
    for k in (16, 8, 4, 2, 1):
        if length & k:
            piece = _rot16(p[k], offset)
            run = piece if run is None else (run & piece)
            offset += k
    return run != 0


def fast_score_map(img: Tensor, threshold: float, arc_length: int = 12,
                   border: int = 3) -> Tensor:
    """FAST corner response map.

    img: (H, W) float32 grayscale.  Returns (H, W) float32: 0 at non-corners
    and inside the keep-out border, else max(sum of bright excess, sum of
    dark excess) over the ring pixels beyond +-threshold.
    """
    if border < 3:
        raise ValueError("border must be >= 3 (the ring radius)")
    img = img.to(torch.float32)
    h, w = img.shape
    # made by a fill on the device (no host-to-device copy), so the function
    # can also be captured into a CUDA graph
    t = torch.full((), threshold, dtype=torch.float32, device=img.device)
    pad = F.pad(img, (3, 3, 3, 3))
    bmask = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    dmask = torch.zeros_like(bmask)
    bsum = torch.zeros_like(img)
    dsum = torch.zeros_like(img)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    for i, (dy, dx) in enumerate(RING_OFFSETS):
        d = pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
        bright = d > t
        dark = d < -t
        bmask |= bright.to(torch.int32) << i
        dmask |= dark.to(torch.int32) << i
        bsum = bsum + torch.where(bright, d - t, zero)
        dsum = dsum + torch.where(dark, -d - t, zero)
    is_corner = has_arc(bmask, arc_length) | has_arc(dmask, arc_length)
    score = torch.maximum(bsum, dsum)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    in_bounds = ((yy >= border) & (yy < h - border)
                 & (xx >= border) & (xx < w - border))
    return torch.where(is_corner & in_bounds, score, zero)
