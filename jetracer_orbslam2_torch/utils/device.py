"""Device resolution: the card unless the caller asks for the CPU.

There is deliberately no "cuda if available else cpu": a run that was meant
for the card and silently lands on the CPU produces timings and behaviour
nobody asked for.  The CPU is a debugging and testing device, chosen
explicitly (`device="cpu"`, `run.py --device cpu`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda:0 (raises without a CUDA device); else the device named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present: jetracer_orbslam2_torch runs on the "
                "GPU by default; pass device='cpu' (or --device cpu) to run "
                "on the CPU explicitly")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is present")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """numpy array / tensor -> float32 tensor on `device`."""
    return torch.as_tensor(x, dtype=torch.float32).to(device)
