"""The mesh's all-reduce through the hand-written CUDA kernel K8, with its
plain version beside it.

`peer_allreduce(x, peers)` sums `x` over the ranks of the default group, in
place.  `parallel/mesh.Mesh` calls it for every collective of a mesh on the
card whose ranks it can map (at most MAX_RANKS, on one host): the
landmark-sharded windowed BA's all-reduces, eager (`Slam`, the host-branch
step, a frame graph's warm-up, `sharded_bundle_adjust`) and inside the
keyframe body of `slam_scan`'s frame graph, the counterpart of the JAX
package's `jax.lax.psum` under `shard_map` inside its keyframe `lax.cond`
(`jetracer_orbslam2_tpu/models/backend/ba.py:394`; no Pallas kernel).
NCCL's own captured all-reduce brings event nodes that a conditional body
may not hold, so the frame graph would not instantiate.  One kernel for
every collective of the mesh: every path sums in the same order.

The plain version, `peer_allreduce_reference`, is `dist.all_reduce(SUM)`:
what a CPU tensor takes, what a mesh K8 cannot serve runs, and what the
host-branch reference step asks for by name (`Mesh.reference`,
`slam_scan._step(plain_collectives=True)`).  On one rank both are a copy;
on more the kernel sums in rank order, the group in its own order, so they
agree to rounding (bit for bit where at most two ranks' partials of an
element are non-zero: a + b = b + a).

The CUDA source is `jetracer_orbslam2_torch/csrc/peer_allreduce.cu`: every
rank maps every peer's receive area through CUDA IPC (`map_peers`, called
by every rank together when a mesh on the card is set up).  A call pushes
this rank's partial into its slot of every rank's area (16-byte stores
over NVLink, from `launch_blocks(n, world)` blocks: one up to 4,096
floats, more at the gather), then each block crosses ONE flag barrier
with the same block of every peer, and sums its slice of the slots in
rank order from local memory.  The area is double-buffered by the parity
of the call's epoch, which is why no second barrier is needed (the
source's header argues it).  One rank launches a kernel that returns at
once (in place there is nothing to sum).  Bound on the card
(`bound_seconds`), what any all-reduce of n floats must move, not what this
one-shot kernel sends: the larger of the input read and the output written
once over 3.35 TB/s and the 2 (world - 1) / world * n floats a rank must
receive over NVLink at least (a reduce-scatter, then an all-gather) over
450 GB/s: 0.031 us at 2,304 floats on four ranks, 0.66 us at 49,152; on one
rank in place, 0 bytes and 0.  A call is latency-bound, by the launch and
one NVLink round trip.
"""

from __future__ import annotations

import ctypes
import socket
from typing import Optional

import torch
import torch.distributed as dist

from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.step_graph import note_launch

Tensor = torch.Tensor

_LIB_NAME = "peer_allreduce"
MAX_RANKS = 8                 # csrc/peer_allreduce.cu's kMaxRanks
MAX_BLOCKS = 16               # its kMaxBlocks: every block resident at once
FLOATS_PER_BLOCK = 4096       # a block's share before the grid grows
# a slot of the receive area, the largest chunk: the windowed BA's largest
# payload, the gather of 16,384 x 3 landmark coordinates, fits whole; a
# larger one goes in chunks
STAGING_FLOATS = 65536

_fns: dict = {}


def _library() -> dict:
    """The library's entries, built and loaded at the first call."""
    if not _fns:
        lib = cuda_build.load_library(_LIB_NAME)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.peer_alloc.argtypes = [ctypes.c_size_t, ctypes.POINTER(ptr)]
        lib.peer_free.argtypes = [ptr]
        lib.peer_handle.argtypes = [ptr, ptr]
        lib.peer_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ptr)]
        lib.peer_close.argtypes = [ptr]
        lib.peer_handle_bytes.restype = ctypes.c_size_t
        lib.peer_allreduce.argtypes = [ctypes.POINTER(ptr), ptr, ptr, i64, i64,
                                       i32, i32, ptr, i32, ptr]
        for name in ("peer_alloc", "peer_free", "peer_handle", "peer_open",
                     "peer_close", "peer_allreduce"):
            getattr(lib, name).restype = i32
            _fns[name] = getattr(lib, name)
        _fns["handle_bytes"] = lib.peer_handle_bytes()
    return _fns


def area_bytes(world: int) -> int:
    """A rank's receive area: `world` slots of STAGING_FLOATS floats, twice
    (the parity of the call's epoch picks one copy)."""
    return 2 * world * STAGING_FLOATS * 4


HBM_BYTES_PER_S = 3.35e12     # one H100's device memory
NVLINK_BYTES_PER_S = 450e9    # one H100's NVLink, each way


def bound_seconds(n: int, world: int) -> float:
    """The least time an in-place all-reduce of n floats over `world` ranks
    could take, whatever its algorithm: the larger of the input read and
    the output written once over HBM and the 2 (world - 1) / world * n
    floats a rank must receive over NVLink (a reduce-scatter, then an
    all-gather, each shard summed by its owner in rank order).  One rank
    moves nothing: 0."""
    if world == 1:
        return 0.0
    return max(2 * 4 * n / HBM_BYTES_PER_S,
               2 * (world - 1) / world * 4 * n / NVLINK_BYTES_PER_S)


def launch_blocks(n: int, world: int) -> int:
    """K8's grid for a payload of n floats over `world` ranks: one block up
    to FLOATS_PER_BLOCK floats a chunk, where a call is latency-bound, then
    one more a FLOATS_PER_BLOCK, so that the pushes of a large payload leave
    from many SMs, at most MAX_BLOCKS (a block waits on the same block of
    its peers, so the grid must be resident at once).  One rank: one block,
    which returns at once."""
    if world == 1:
        return 1
    chunk = min(n, STAGING_FLOATS)
    return max(1, min(MAX_BLOCKS, -(-chunk // FLOATS_PER_BLOCK)))


def _check_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


class PeerBuffers:
    """Every rank's receive area as this process sees it: its own, and each
    peer's mapped through CUDA IPC, with the device counters of the
    kernel's barriers (`epoch`: the chunks done, and the blocks of the
    current call that finished).  Made by `map_peers`, outside any
    capture.  A CUDA graph that holds K8 must not outlive them."""

    def __init__(self, rank: int, world: int, device: torch.device, own: int,
                 bases: list, opened: list):
        self.rank, self.world, self.device = rank, world, device
        self._own, self._opened = own, opened
        self.bases = (ctypes.c_void_p * world)(*bases)
        self.epoch = torch.zeros(2, dtype=torch.int32, device=device)

    def close(self) -> None:
        """Unmap the peers' buffers, wait for every rank to do the same, and
        free this rank's own.  Every rank calls it together."""
        if self._own is None:
            return
        fns = _library()
        for p in self._opened:
            fns["peer_close"](p)
        self._opened = []
        torch.cuda.synchronize(self.device)
        if self.world > 1:
            dist.barrier()
        fns["peer_free"](self._own)
        self._own = None


def map_peers(rank: int, world: int,
              device: torch.device) -> Optional[PeerBuffers]:
    """The ranks' receive areas, mapped by every rank of the default group
    together (each allocates its own and the handles go round with
    `all_gather_object`; a one-rank group exchanges nothing).  None, the same
    on every rank, where K8 cannot serve the group: more than MAX_RANKS
    ranks (then nothing is allocated or exchanged), or ranks on more than
    one host (CUDA IPC maps memory of one host only)."""
    if world > MAX_RANKS:
        return None
    fns = _library()
    own = ctypes.c_void_p()
    _check_error(fns["peer_alloc"](area_bytes(world), ctypes.byref(own)),
                 "peer_alloc")
    handle = ctypes.create_string_buffer(fns["handle_bytes"])
    _check_error(fns["peer_handle"](own.value, handle), "peer_handle")
    entries = [(socket.gethostname(), handle.raw)]
    if world > 1:
        entries = [None] * world
        dist.all_gather_object(entries, (socket.gethostname(), handle.raw))
    if len({host for host, _ in entries}) > 1:
        fns["peer_free"](own.value)
        return None
    bases, opened = [], []
    for r, (_, h) in enumerate(entries):
        if r == rank:
            bases.append(own.value)
            continue
        peer = ctypes.c_void_p()
        _check_error(fns["peer_open"](h, ctypes.byref(peer)),
                     f"peer_open of rank {r}")
        bases.append(peer.value)
        opened.append(peer.value)
    return PeerBuffers(rank, world, device, own.value, bases, opened)


def peer_allreduce_reference(x: Tensor) -> None:
    """Plain version: `dist.all_reduce(SUM)` of `x` in place over the default
    group (NCCL on the card, gloo on the CPU)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM)


def peer_allreduce(x: Tensor, peers: Optional[PeerBuffers]) -> None:
    """Sum `x` over the ranks, in place.  A CUDA tensor goes through K8 on the
    current stream (a float32, contiguous tensor on the peers' device; no
    host wait, so a CUDA graph can capture it); a CPU tensor through the
    plain version."""
    if x.device.type == "cpu":
        peer_allreduce_reference(x)
        return
    if peers is None:
        raise ValueError("K8 needs the ranks' PeerBuffers (`map_peers`)")
    if x.device != peers.device:
        raise ValueError(f"x lies on {x.device}, the peers' buffers on "
                         f"{peers.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"K8 takes a contiguous float32 tensor, got {x.dtype}"
                        f"{'' if x.is_contiguous() else ', not contiguous'}")
    err = _library()["peer_allreduce"](
        peers.bases, x.data_ptr(), x.data_ptr(), x.numel(), STAGING_FLOATS,
        peers.rank, peers.world, peers.epoch.data_ptr(),
        launch_blocks(x.numel(), peers.world),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_error(err, "peer_allreduce launch")
    note_launch(peer_allreduce)


peer_allreduce.launches = 0
