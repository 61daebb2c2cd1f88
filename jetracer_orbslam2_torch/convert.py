"""Carry feature sets and odometry state between numpy and the port's tuples.

The system has no learned weights; the state two implementations must share
(in tests, or when resuming a run made elsewhere) is a frame's `Features` and
the `OdomState`.  This module takes and returns numpy arrays only — field
names and layouts are those of `models/frontend.Features` and
`models/odometry.OdomState`, with descriptors as `uint32` words on the numpy
side and `int32` words of the same bit pattern on the tensor side.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from jetracer_orbslam2_torch.models.frontend import Features
from jetracer_orbslam2_torch.models.odometry import OdomState, make_generator
from jetracer_orbslam2_torch.utils.device import resolve_device

_FEATURE_DTYPES = {
    "xy": np.float32, "level": np.int32, "score": np.float32,
    "angle": np.float32, "desc": np.uint32, "valid": np.bool_,
    "points": np.float32, "has_point": np.bool_,
}


def desc_from_numpy(desc: np.ndarray, device) -> torch.Tensor:
    """(K, W) uint32 -> int32 tensor with the same bits."""
    words = np.ascontiguousarray(np.asarray(desc, dtype=np.uint32))
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """(K, W) int32 tensor -> uint32 array with the same bits."""
    return np.ascontiguousarray(desc.cpu().numpy()).view(np.uint32)


def features_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> Features:
    """Dict of numpy arrays keyed by `Features` field name -> `Features`."""
    dev = resolve_device(device)
    out = {}
    for name, dtype in _FEATURE_DTYPES.items():
        a = np.asarray(fields[name])
        if name == "desc":
            out[name] = desc_from_numpy(a, dev)
        else:
            out[name] = torch.from_numpy(
                np.ascontiguousarray(a.astype(dtype))).to(dev)
    return Features(**out)


def features_to_numpy(feats: Features) -> dict:
    out = {}
    for name in _FEATURE_DTYPES:
        t = getattr(feats, name)
        out[name] = desc_to_numpy(t) if name == "desc" else t.cpu().numpy()
    return out


def odom_state_from_numpy(T_wc, velocity, prev: Mapping[str, np.ndarray],
                          frame_idx: int = 0, seed: int = 0,
                          device=None) -> OdomState:
    """Rebuild an `OdomState`.  The RANSAC stream is not portable between
    frameworks, so the generator is made afresh from `seed`."""
    dev = resolve_device(device)
    f32 = lambda a: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.float32))).to(dev)
    return OdomState(
        T_wc=f32(T_wc), velocity=f32(velocity),
        prev=features_from_numpy(prev, dev),
        frame_idx=torch.tensor(int(frame_idx), dtype=torch.int32, device=dev),
        generator=make_generator(seed, dev),
    )


def odom_state_to_numpy(state: OdomState) -> dict:
    """All array fields of the state (the generator is left out)."""
    return {
        "T_wc": state.T_wc.cpu().numpy(),
        "velocity": state.velocity.cpu().numpy(),
        "prev": features_to_numpy(state.prev),
        "frame_idx": int(state.frame_idx.cpu()),
    }
