"""ORB: intensity-centroid orientation + rotated BRIEF-256 descriptors.

Counterpart of `jetracer_orbslam2_tpu/ops/orb.py`: the same fixed BRIEF
pattern (numpy `RandomState(0x0B5E55ED)`), the same rotation bins, the same
bit layout.  The JAX version selects the two pattern pixels of every bit with
a row-one-hot matmul (a TPU device); here each keypoint gathers them directly
from its own rotation bin's index table.

Descriptors are (K, 8) int32 holding the same bit pattern as the JAX
package's uint32 words (`torch.uint32` supports few ops and no shifts);
compare across the two through `numpy.view`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from jetracer_orbslam2_torch.utils.consts import const_table

Tensor = torch.Tensor

_PATTERN_SEED = 0x0B5E55ED
_PATTERN_CLIP = 12  # max |coord|; rotated stays within radius 17 < 18


@functools.lru_cache(maxsize=None)
def brief_pattern(num_bits: int = 256, patch_size: int = 37) -> np.ndarray:
    """(num_bits, 2, 2) float32 point pairs (x, y) in patch coords.

    BRIEF 'G II' sampling: both points i.i.d. N(0, (S/5)^2), clipped so any
    rotation stays inside the patch.
    """
    rng = np.random.RandomState(_PATTERN_SEED)
    sigma = patch_size / 5.0
    pts = rng.randn(num_bits, 2, 2) * sigma
    pts = np.clip(pts, -_PATTERN_CLIP, _PATTERN_CLIP)
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def rotated_pattern_indices(
    num_bits: int = 256, patch_size: int = 37, num_angle_bins: int = 32
) -> np.ndarray:
    """(num_angle_bins, 2, num_bits) int32 flat patch indices.

    Entry [b, j, i] = flattened (y * P + x) index of point j of pair i under
    rotation by angle 2*pi*b/num_angle_bins, relative to patch center.
    """
    pts = brief_pattern(num_bits, patch_size)  # (N, 2, 2) as (x, y)
    r = patch_size // 2
    out = np.zeros((num_angle_bins, 2, num_bits), dtype=np.int32)
    for b in range(num_angle_bins):
        a = 2.0 * np.pi * b / num_angle_bins
        c, s = np.cos(a), np.sin(a)
        x = pts[..., 0] * c - pts[..., 1] * s
        y = pts[..., 0] * s + pts[..., 1] * c
        xi = np.clip(np.rint(x).astype(np.int32) + r, 0, patch_size - 1)
        yi = np.clip(np.rint(y).astype(np.int32) + r, 0, patch_size - 1)
        out[b] = (yi * patch_size + xi).T
    return out


def _disc_weights(p: int, disc_radius: int) -> np.ndarray:
    """(2, P*P) float32: x and y offsets inside the centered disc, else 0."""
    coords = np.arange(p, dtype=np.float32) - (p // 2)
    dy, dx = coords[:, None], coords[None, :]
    disc = (dx * dx + dy * dy) <= float(disc_radius * disc_radius)
    wx = np.where(disc, dx, np.float32(0.0)).astype(np.float32)
    wy = np.where(disc, dy, np.float32(0.0)).astype(np.float32)
    return np.stack([wx.reshape(-1), wy.reshape(-1)])


def orientation(patches: Tensor, disc_radius: int = 15) -> Tensor:
    """Intensity-centroid angle per patch: (K, P, P) -> (K,) radians.

    theta = atan2(m01, m10), moments over the centered disc.  The two
    ~700-term sums are accumulated in float64 and rounded once, so the angle
    (and with it the rotation bin) does not depend on the order in which a
    device happens to add; the JAX package sums in float32, so the two agree
    to its rounding error, not bit for bit.
    """
    k, p, _ = patches.shape
    w = const_table(("orb_disc", p, disc_radius),
                    lambda: _disc_weights(p, disc_radius).astype(np.float64),
                    patches.device)
    m = (patches.reshape(k, p * p).double() @ w.T).float()   # (K, 2): m10, m01
    return torch.atan2(m[:, 1], m[:, 0])


def angle_bins(angles: Tensor, num_angle_bins: int) -> Tensor:
    """Quantize angles [rad] to rotation-bin indices (K,) int32.

    `remainder` (sign of the divisor, like `%` in JAX), then round half to
    even like `jnp.round`."""
    two_pi = 2.0 * math.pi
    frac = torch.remainder(angles, two_pi) / two_pi
    bins = torch.round(frac * num_angle_bins).to(torch.int32)
    return torch.clamp(torch.remainder(bins, num_angle_bins),
                       0, num_angle_bins - 1)


def _bit_weights() -> np.ndarray:
    return (np.int64(1) << np.arange(32, dtype=np.int64))


def describe(
    patches: Tensor,
    angles: Tensor,
    num_bits: int = 256,
    num_angle_bins: int = 32,
) -> Tensor:
    """Rotated BRIEF: (K, P, P) patches + (K,) angles -> (K, num_bits/32)
    int32 (bit pattern of the JAX package's uint32 words).

    Each keypoint evaluates only its own rotation bin; bit i is the exact
    sign test I(p1_i) < I(p2_i) on gathered f32 pixels.
    """
    k, p, _ = patches.shape
    dev = patches.device
    table = const_table(
        ("orb_rot", num_bits, p, num_angle_bins),
        lambda: rotated_pattern_indices(num_bits, p, num_angle_bins).astype(np.int64),
        dev)                                            # (B, 2, N)
    bins = angle_bins(angles, num_angle_bins).long()
    idx = table[bins].reshape(k, 2 * num_bits)          # (K, 2N)
    vals = patches.reshape(k, p * p).gather(1, idx)     # (K, 2N)
    d = vals[:, :num_bits] - vals[:, num_bits:]
    bits = (d < 0).to(torch.int64).reshape(k, num_bits // 32, 32)
    weights = const_table("orb_bit_weights", _bit_weights, dev)
    words = (bits * weights).sum(-1)                    # in [0, 2^32)
    # same 32 bits as a two's-complement int32 (bit 31 -> sign)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(desc: Tensor, num_bits: int = 256) -> Tensor:
    """(K, W) int32 -> (K, num_bits) float32 in {0, 1}."""
    k = desc.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1     # arithmetic shift; & 1 keeps bit
    return bits.reshape(k, num_bits).to(torch.float32)
