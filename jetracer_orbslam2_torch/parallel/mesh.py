"""Process groups as meshes, and the multi-process bootstrap.

Counterpart of `jetracer_orbslam2_tpu/parallel/mesh.py`.  There a mesh is a
`jax.sharding.Mesh` over devices and a sharded program runs under
`shard_map`.  Here a mesh is a `torch.distributed` process group with ONE
PROCESS PER RANK: every rank runs the same program on its own device, owns
one block of the landmark axis, and each `psum` of the JAX program is an
`all_reduce(SUM)` over the group.  A one-rank group runs the identical
program, so the single-card path and the multi-card path are one code path.
On the card that all-reduce is the hand-written kernel K8
(`ops/fused_allreduce.py`), eager and inside a CUDA graph alike, so every
path sums in the same (rank) order; the group's own all-reduce is its plain
version, and the collectives of a mesh K8 cannot serve (more than 8 ranks,
several hosts), whose `slam_scan` then takes the host-branch route.

  * `init_distributed` joins a group from its arguments or from the
    variables `python -m torch.distributed.run` sets (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).  With nothing set it returns
    False and does nothing.
  * `make_mesh` wraps the joined group, or, with no group up and n in
    (None, 1), builds a one-rank group over an in-process store (no TCP
    port).
  * The backend is NCCL for a CUDA mesh and gloo for a CPU mesh unless one
    is named.  The device is `cuda:LOCAL_RANK` unless the caller asks for
    another one; a mesh never falls back to the CPU (the JAX `virtual_mesh`
    falls back to virtual CPU devices; this one raises instead).

The JAX module's `replicated` and `sharded_axis0` build `NamedSharding`s,
which have no meaning here: a rank holds whole tensors, and which block of
the landmark axis it owns is its rank (`Mesh.block`).
"""

from __future__ import annotations

import copy
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from jetracer_orbslam2_torch.ops import fused_allreduce
from jetracer_orbslam2_torch.utils import step_graph
from jetracer_orbslam2_torch.utils.device import resolve_device

Tensor = torch.Tensor

# every group gets a timeout: a rank that leaves the lockstep (or dies) fails
# the others' collectives instead of hanging them
GROUP_TIMEOUT = datetime.timedelta(minutes=5)


def rank_device(device=None) -> torch.device:
    """None -> cuda:LOCAL_RANK (raises without a CUDA device); else the
    device named.  The CPU only on request."""
    if device is None:
        return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    return resolve_device(device)


def _backend_for(dev: torch.device) -> str:
    return "gloo" if dev.type == "cpu" else "nccl"


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join a multi-process group.  Call once per process, before any mesh.

    With no arguments the variables of `torch.distributed.run` drive it
    (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK; LOCAL_RANK picks the
    card).  Returns True when a group of more than one rank is up, False for
    the single-process fallback: with nothing set it does nothing, and the
    caller proceeds identically either way (`make_mesh` then builds a
    one-rank group).  device: the rank's device (None = cuda:LOCAL_RANK),
    which also picks the backend (NCCL for CUDA, gloo for the CPU) unless
    `backend` names one.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and world_size is None and not (
            "MASTER_ADDR" in env and "WORLD_SIZE" in env):
        return False
    world_size = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or _backend_for(dev), init_method=init_method or "env://",
        world_size=world_size, rank=rank, timeout=GROUP_TIMEOUT)
    return world_size > 1


class Mesh:
    """One axis of ranks over a process group (the default group).

    `size` ranks, this process is `rank` on `device`.  The landmark axis of a
    problem whose length is a multiple of `size` splits into `size` equal
    blocks; rank r owns block r.  A mesh on the card holds the ranks' staging
    buffers of K8 (`ops/fused_allreduce.map_peers`, made by every rank
    together at set-up, whatever the backend), and every collective of the
    mesh is K8, eager or inside a CUDA graph's capture; where K8 cannot serve
    the group (more than 8 ranks, or ranks on several hosts) `peers` is None,
    `k8_unservable` says why, and the collectives are the group's own, which
    a frame graph refuses (`check_capturable`): `slam_scan` with such a mesh
    runs its frames through the host-branch step, as `Slam` does.  That
    record is made at set-up and never changes, so the route cannot switch
    in the middle of a run.  A CPU mesh runs the group's.  An LM
    iteration's four pose-sized partials go through `psum_many`, one
    collective.  `close()` releases the buffers, and destroys the group if
    this mesh built it (a one-rank group), leaving a joined group alone; a
    closed mesh on the card takes no route (`check_capturable` and
    `slam_scan` raise).
    """

    def __init__(self, device: torch.device, axis: str = "lm",
                 owns_group: bool = False):
        self.axis = axis
        self.device = device
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.owns_group = owns_group
        self.peers = None
        # why K8 does not serve this mesh on the card, None where it does
        # (and on the CPU): recorded here, at set-up, never after
        self.k8_unservable: Optional[str] = None
        if device.type == "cuda":
            self.peers = fused_allreduce.map_peers(self.rank, self.size, device)
            if self.peers is None:
                self.k8_unservable = (
                    f"more than {fused_allreduce.MAX_RANKS} ranks"
                    if self.size > fused_allreduce.MAX_RANKS
                    else "ranks on several hosts")

    def reference(self) -> "Mesh":
        """This mesh with the plain version of its collectives, the group's
        `dist.all_reduce`: the host-branch reference step's
        (`slam_scan._step(plain_collectives=True)`).  It shares the group
        and has nothing of its own to close."""
        view = copy.copy(self)
        view.owns_group, view.peers = False, None
        view.k8_unservable = "the plain reference (Mesh.reference)"
        return view

    @property
    def capturable(self) -> bool:
        """Whether this mesh's collectives can be nodes of a CUDA graph's
        conditional body: on the card they must be K8 (the group's captured
        all-reduce holds event nodes, which a body refuses); on the CPU a
        frame graph runs its bodies as host `if`s.  Set by the mesh as it
        was set up (`map_peers`), never by a failure; False once closed."""
        return self.device.type != "cuda" or self.peers is not None

    @property
    def closed(self) -> bool:
        """A mesh on the card whose K8 buffers `close()` released: it has
        neither K8 nor a reason recorded at set-up for doing without."""
        return (self.device.type == "cuda" and self.peers is None
                and self.k8_unservable is None)

    def check_capturable(self) -> None:
        """Raise unless `capturable`."""
        if self.closed:
            raise RuntimeError(f"{self!r}: closed, its K8 buffers released")
        if not self.capturable:
            raise RuntimeError(
                f"{self!r}: a frame graph needs the mesh's collectives to be "
                f"K8, which maps the ranks' buffers over CUDA IPC: at most "
                f"{fused_allreduce.MAX_RANKS} ranks on one host, and not the "
                f"plain reference (Mesh.reference)")

    def block(self, length: int) -> slice:
        """This rank's block of an axis of `length` (a multiple of size)."""
        if length % self.size:
            raise ValueError(f"an axis of {length} does not split into "
                             f"{self.size} equal blocks")
        lb = length // self.size
        return slice(self.rank * lb, (self.rank + 1) * lb)

    def _all_reduce(self, x: Tensor) -> None:
        """In-place SUM over the group, queued on the current stream: K8 on
        the buffers the mesh mapped at set-up, or, without them, the
        group's all-reduce (its plain version)."""
        if self.peers is None:
            fused_allreduce.peer_allreduce_reference(x)
        else:
            fused_allreduce.peer_allreduce(x, self.peers)

    def psum(self, x: Tensor) -> Tensor:
        """Sum of `x` over the ranks (a new tensor).  Queued on the current
        stream: no host wait."""
        y = x.clone(memory_format=torch.contiguous_format)
        self._all_reduce(y)
        return y

    def psum_many(self, *xs: Tensor) -> tuple:
        """The sums of several partials over the ranks in ONE collective:
        one buffer (its `torch.cat` takes the place of `psum`'s clones),
        one in-place all-reduce, and views of it in the partials' shapes.
        Bit for bit a `psum` each: K8 and the one-rank group sum every
        element in rank order, whatever the packing.  Queued on the current
        stream: no host wait."""
        flat = torch.cat([x.reshape(-1) for x in xs])
        self._all_reduce(flat)
        return tuple(part.view(x.shape) for part, x in
                     zip(flat.split([x.numel() for x in xs]), xs))

    def gather_blocks(self, block: Tensor) -> Tensor:
        """Concatenate every rank's `block` along axis 0, on every rank.

        An all-reduce of a zero-filled buffer into which each rank wrote its
        own block (adding +0 is exact): gloo has no `all_gather` of CUDA
        tensors, and both backends have `all_reduce`."""
        lb = block.shape[0]
        full = block.new_zeros((self.size * lb,) + tuple(block.shape[1:]))
        full[self.rank * lb:(self.rank + 1) * lb] = block
        self._all_reduce(full)
        return full

    def close(self) -> None:
        """Drop the graphs keyed on this mesh (their K8 nodes point into its
        buffers: a handle that still holds one raises), release the
        buffers, and destroy the group if this mesh built it."""
        step_graph.drop_graphs(self)
        if self.peers is not None and dist.is_initialized():
            self.peers.close()
        self.peers = None
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        route = ("K8" if self.peers is not None else "closed" if self.closed
                 else f"plain collectives: {self.k8_unservable or 'CPU'}")
        return (f"Mesh({self.axis}={self.size}, rank {self.rank}, "
                f"{self.backend} on {self.device}, {route})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "lm",
              device=None) -> Mesh:
    """A mesh over the joined group (its world size must be `n_devices` when
    given), or, with no group up and `n_devices` in (None, 1), over a new
    one-rank group on `device` (None = cuda:LOCAL_RANK; "cpu" on request),
    which the mesh owns and `close()` destroys.  More ranks than one need
    processes: start them with `python -m torch.distributed.run
    --nproc-per-node N` and call `init_distributed()` first."""
    dev = rank_device(device)
    if dist.is_initialized():
        size = dist.get_world_size()
        if n_devices is not None and n_devices != size:
            raise ValueError(f"a mesh of {n_devices} ranks was asked for, the "
                             f"joined group has {size}")
        if dev.type == "cpu" and dist.get_backend() == "nccl":
            raise ValueError("an NCCL group cannot reduce CPU tensors")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return Mesh(dev, axis)
    if n_devices not in (None, 1):
        raise ValueError(
            f"a mesh of {n_devices} ranks needs a group of {n_devices} "
            f"processes: run under python -m torch.distributed.run "
            f"--nproc-per-node {n_devices} and call init_distributed() first")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend_for(dev), store=dist.HashStore(), rank=0,
                            world_size=1, timeout=GROUP_TIMEOUT)
    return Mesh(dev, axis, owns_group=True)


def virtual_mesh(n_devices: int, axis: str = "lm", device=None) -> Mesh:
    """`make_mesh(n_devices)`.  The JAX function falls back to virtual CPU
    devices when the host has too few chips; a rank here is a process, so
    there is nothing to fall back to, and none is made up."""
    return make_mesh(n_devices, axis, device)


def map_mesh(mesh: Optional[Mesh] = None, device=None) -> Mesh:
    return mesh if mesh is not None else make_mesh(device=device)
