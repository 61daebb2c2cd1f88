"""Device resolution: the card unless the caller asks for the CPU.

There is deliberately no "cuda if available else cpu": a run that was meant
for the card and silently lands on the CPU produces timings and behaviour
nobody asked for.  The CPU is a debugging and testing device, chosen
explicitly (`device="cpu"`, `run.py --device cpu`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


class _Slot(NamedTuple):
    pinned: tuple                # `flat` as the inputs' shapes, NumPy
    staged: torch.Tensor         # (n,) float32 on the device
    views: tuple                 # `staged` as the inputs' shapes
    flat: torch.Tensor           # (n,) float32, pinned host memory
    copied: torch.cuda.Event     # the transfer, on the copy stream
    read: torch.cuda.Event       # the reader's work that reads `staged`


class HostStaging:
    """Host frames to `device` as float32 tensors, with no wait on the
    stream that reads them.

    On a CUDA device, `to_device(*xs)` copies the host arrays into one slot
    of a ring of SLOTS pairs of buffers, one in pinned host memory and one
    on the device.  The host copy runs inside the call, on the calling
    thread (NumPy), so the caller may reuse its own buffers as soon as the
    call returns.  The slot then goes to the device in one `non_blocking`
    transfer on a copy stream of the staging's own, and the current stream
    (the reader) waits on an event recorded after it: the transfer neither
    waits for the work queued on the reader nor is queued behind it, and
    what the reader runs after the call reads the frame.

    The call returns views of the slot's device buffer, which the call
    after next rewrites: a caller queues its reads of them on the reader
    before its next call, whose event on the reader orders the rewrite
    after them.  Before a slot's pinned buffer is refilled, the host waits
    for its transfer only where that has not completed yet (`waits` counts
    those waits).

    Tensors already on a CUDA device, and every input on the CPU, take the
    plain path (`as_f32`)."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.waits = 0
        self._slots: list = [None] * self.SLOTS
        self._next = 0
        self._last: _Slot | None = None
        self._stream = (torch.cuda.Stream(device=device)
                        if device.type == "cuda" else None)

    def to_device(self, *xs) -> tuple[torch.Tensor, ...]:
        if self._stream is None or any(
                isinstance(x, torch.Tensor) and x.is_cuda for x in xs):
            return tuple(as_f32(x, self.device) for x in xs)
        host = [torch.as_tensor(x, dtype=torch.float32).numpy(force=True)
                for x in xs]
        reader = torch.cuda.current_stream(self.device)
        if self._last is not None:
            self._last.read.record(reader)
        i = self._next
        self._next = (i + 1) % self.SLOTS
        slot = self._slots[i]
        if slot is not None and not slot.copied.query():
            self.waits += 1
            slot.copied.synchronize()
        if slot is None or [v.shape for v in slot.views] != [
                h.shape for h in host]:
            slot = self._slots[i] = self._slot(host, reader)
        for pinned, h in zip(slot.pinned, host):
            np.copyto(pinned, h)
        torch.cuda.set_stream(self._stream)
        try:
            self._stream.wait_event(slot.read)
            slot.staged.copy_(slot.flat, non_blocking=True)
            slot.copied.record(self._stream)
        finally:
            torch.cuda.set_stream(reader)
        reader.wait_event(slot.copied)
        self._last = slot
        return slot.views

    def _slot(self, host: list, reader) -> _Slot:
        """A slot for inputs of `host`'s shapes."""
        n = sum(h.size for h in host)
        flat = torch.empty(n, dtype=torch.float32, pin_memory=True)
        staged = torch.empty(n, dtype=torch.float32, device=self.device)
        # the device block may be one the reader freed: the copy stream
        # writes it after the reader's work queued so far
        self._stream.wait_stream(reader)
        return _Slot(tuple(v.numpy() for v in _split(flat, host)), staged,
                     _split(staged, host), flat, torch.cuda.Event(),
                     torch.cuda.Event())


def _split(flat: torch.Tensor, like: list) -> tuple:
    """`flat` cut into views of the shapes of `like`, in order."""
    out, at = [], 0
    for h in like:
        out.append(flat[at:at + h.size].view(h.shape))
        at += h.size
    return tuple(out)
