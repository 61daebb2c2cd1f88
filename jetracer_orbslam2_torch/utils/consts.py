"""Device-resident constants, made once per (table, device).

The frame loop must not upload small tables every frame: each
`torch.tensor(list, device="cuda")` is a host-to-device copy.  Tables that
depend only on static configuration are built here and cached.
"""

from __future__ import annotations

import numpy as np
import torch

_cache: dict = {}


def const_table(key, make, device) -> torch.Tensor:
    """A cached tensor built from the numpy array `make()` returns; `key`
    (hashable) names the table."""
    k = (key, str(device))
    t = _cache.get(k)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(make())).to(device)
        _cache[k] = t
    return t
