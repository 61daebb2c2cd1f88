"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: both sides get the same numpy inputs; JAX runs on the CPU as in its
own tests, the port runs with device="cpu"."""

import numpy as np
import torch

FEATURE_FIELDS = ("xy", "level", "score", "angle", "desc", "valid",
                  "points", "has_point")


def t(a, dtype=None):
    """numpy -> CPU tensor (copying, so neither side sees the other's edits)."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def image_u8(shape, seed=0):
    """Integer-valued f32 image: every blur/pyramid intermediate of the first
    two levels is exactly representable, so no summation order can differ."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape).astype(np.float32)


def jax_features_to_numpy(feats) -> dict:
    """JAX `Features` -> dict of numpy arrays (desc stays uint32)."""
    return {name: np.asarray(getattr(feats, name)) for name in FEATURE_FIELDS}
