"""Map checkpointing: save the keyframe map and resume from it.

Counterpart of `jetracer_orbslam2_tpu/runtime/checkpoint.py`, in its format:
a directory with `arrays.npz` (one `map_<field>` array per `MapState` field)
and `meta.json` (`format: 1`, the field names, the caller's `extra`).  The
arrays go through `convert.map_state_to_numpy` / `map_state_from_numpy`, so
descriptors are `uint32` on disk as the JAX package writes them (the port
holds their bit patterns as `int32`), and a checkpoint written by either
package loads in the other.  The reference has no checkpointing (SURVEY.md
§5).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.models.backend.map import MapState
from jetracer_orbslam2_torch.utils.device import resolve_device

_META = "meta.json"
_ARRAYS = "arrays.npz"


def save_checkpoint(path: str, m: MapState,
                    extra: Optional[dict] = None) -> None:
    """Write the map (+ JSON-serializable extras) to a directory."""
    os.makedirs(path, exist_ok=True)
    arrays = {f"map_{name}": a
              for name, a in convert.map_state_to_numpy(m).items()}
    np.savez(os.path.join(path, _ARRAYS), **arrays)
    meta = {"format": 1, "fields": list(m._fields)}
    if extra:
        meta["extra"] = extra
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, device=None) -> tuple[MapState, dict]:
    """Read a checkpoint directory back into a MapState (+ extras) on
    `device` (None is cuda:0 and raises without a CUDA device; "cpu" on
    request)."""
    dev = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, _ARRAYS)) as data:
        fields = {name: data[f"map_{name}"] for name in meta["fields"]}
    return convert.map_state_from_numpy(fields, dev), meta.get("extra", {})
