"""A fixed-shape step captured once into a CUDA graph and replayed each call.

The JAX package compiles its frame step once (`jit`, `lax.scan`) and
dispatches it once a frame.  The port's counterpart is a CUDA graph:
`StepGraph(fn, generator)` wraps `fn(generator, *inputs)`, whose inputs and
outputs are tensors or (named) tuples of tensors of fixed shapes.

One graph per configuration, as `jax.jit` compiles one program per
configuration: the captured graphs live in a process-wide cache keyed by
what `fn` closes over (the caller's `key`: configuration, device, the
graph's kind, a mesh) and by the structure, plain values, shapes and dtypes
of its state and inputs.  A `StepGraph` or `FrameGraph` is one run's handle
on the graph of its key, with the run's generator and counters; another
shape is another key and another graph.  Each device keeps CACHE_SIZE
graphs, the least recently used leaving first (a handle keeps its graph);
`clear_graph_cache` is `jax.clear_caches`, and a mesh's graphs go with
`Mesh.close` (`drop_graphs`).

On a CUDA device, for a key not in the cache:
  * the first call runs `fn` eagerly on the graph's side stream, with the
    run's generator: it is a real step (its draws are the run's) and the
    warm-up that builds the kernels and fills every cached constant;
  * the second call copies its inputs into static buffers, captures `fn` on
    them with the graph's own generator registered with the graph
    (`CUDAGraph.register_generator_state`), and replays it; every later call
    copies the inputs that changed into the buffers and replays.
A key in the cache replays from a run's first call.  Before each replay the
graph's own generator takes the run's generator's state and after it hands
the advanced state back, so a run draws what a graph captured with its own
generator would draw; a replay advances the generator as an eager step
would, so eager draws between replays keep their order.  Outputs are cloned
out of the graph's pool, which the next replay overwrites.  A capture that
fails raises; there is no eager fallback.

On the CPU every call runs `fn` eagerly through the same static buffers and
the same cache, so the tests exercise the keys, the copies in and out and
the generator's hand-over.

An input is copied into its buffer only when it is another tensor than the
one copied last time, or the same tensor modified in place since (its
version counter moved): a map that changes only at keyframes is copied only
then.

Kernel wrappers count their launches through `note_launch`: an eager launch
adds one to the wrapper's `launches`; a call made while a `StepGraph`
captures adds a node to that graph instead, and each replay adds the graph's
nodes.  So `launches` keeps counting the kernel's launches on the card.

`FrameGraph` is the same for a step that carries a state from call to call
and branches on the device, the JAX package's `lax.cond` inside its
compiled frame: the step rewrites the carried state in place (its buffers
live in the graph) and `cond(pred, body)` records `body` as a conditional
(`if`) node of the frame's graph (`csrc/graph_cond.cu`), which runs at a
replay only where the predicate in device memory holds.  A body's kernels
count once for each replay that took the body: the graph counts on the
device how many replays took each body, and `settle_launches` (or a caller
that fetches the counts with its outputs, `FrameGraph.settle`) adds them.
Each body also opens and closes with a one-thread kernel node that reads
the device's clock, so the graph sums each body's device ns beside its
count (`FrameGraph.branch_counts`); a body's time includes the bodies
inside it.

Spans (`utils/timing.RECORDER`): `graph.replay` for every call of a
StepGraph or FrameGraph (the copies into the buffers, the generator's
hand-over, the launch and the output copies; the bytes copied in as its
value), `graph.warmup`, `graph.capture` and `graph.instantiate` for a
graph's cold start, and `graph.body.<name>` for each body run as a host
branch (its host ns as the value).
"""

from __future__ import annotations

import collections
import ctypes
import gc
import time
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch

from jetracer_orbslam2_torch.utils.timing import RECORDER

Tensor = torch.Tensor

# wrapper -> calls made during the StepGraph capture in progress (in a
# FrameGraph's conditional body: the body's own record)
_recording: Optional[dict] = None
# True while a FrameGraph warms up: every `cond` body runs, nothing counts
_warming = False
# the FrameGraph capture in progress (its bodies, streams and pools)
_frame_capture: Optional["_Capture"] = None


def note_launch(wrapper) -> None:
    """Count one launch of the kernel behind `wrapper` (a function with a
    `launches` attribute), called by the wrapper right after it launched on
    the current stream.  A FrameGraph's warm-up, which runs on a copy of the
    state and is thrown away, counts none."""
    if _warming:
        return
    if torch.cuda.is_current_stream_capturing():
        # a node of a graph: counted at each replay of a StepGraph (a graph
        # captured elsewhere, as chip_smoke.py's timing graphs, counts none)
        if _recording is not None:
            _recording[wrapper] = _recording.get(wrapper, 0) + 1
        return
    wrapper.launches += 1


def _flatten(tree, leaves: list):
    """Tensors of `tree` appended to `leaves`; returns the structure with
    each tensor replaced by its index (None and plain values kept), as
    nested tuples: hashable, so it can be part of a cache key."""
    if isinstance(tree, Tensor):
        leaves.append(tree)
        return len(leaves) - 1
    if isinstance(tree, tuple):
        return ("tuple", type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, list):
        return ("list", list, tuple(_flatten(x, leaves) for x in tree))
    return ("leaf", tree)


def _unflatten(spec, leaves: list):
    if isinstance(spec, int):
        return leaves[spec]
    kind = spec[0]
    if kind == "leaf":
        return spec[1]
    items = [_unflatten(x, leaves) for x in spec[2]]
    if kind == "list":
        return items
    cls = spec[1]
    return cls(*items) if cls is not tuple and hasattr(cls, "_fields") else tuple(items)


def _signature(leaves: list) -> tuple:
    """Each leaf's shape, dtype and device: with the structure, what tells
    one graph of a configuration from another (as a shape does a jit
    compile)."""
    return tuple((tuple(x.shape), x.dtype, x.device) for x in leaves)


class _OtherShape(ValueError):
    """A tensor of another shape, dtype or device than the graph's buffer."""


def _load(owner: str, leaves: list, static: Optional[list], copied: list,
          what: str, sig: tuple) -> tuple[list, int]:
    """(The static buffers holding `leaves`, the bytes copied into them):
    the buffers made at the first call (copies), then each leaf copied in
    only when it is another tensor than the one copied last time, or the
    same tensor modified in place since (its version counter moved).
    `copied` holds (a weak reference to the tensor, its version) of each,
    so a buffer keeps no caller's tensor alive.  Raises `_OtherShape` for
    leaves that do not fit the buffers (`sig`)."""
    if static is None:
        if _signature(leaves) != sig:
            raise _OtherShape(f"{owner}: the {what} tensors' shapes differ "
                              f"from the graph's")
        copied[:] = [(weakref.ref(x), x._version) for x in leaves]
        return ([x.clone() for x in leaves],
                sum(x.numel() * x.element_size() for x in leaves))
    if len(leaves) != len(static):
        raise _OtherShape(f"{owner}: {len(leaves)} {what} tensors, the graph "
                          f"has {len(static)}")
    nbytes = 0
    for i, (x, s) in enumerate(zip(leaves, static)):
        last, version = copied[i]
        if last() is x and x._version == version:
            continue
        if x.shape != s.shape or x.dtype != s.dtype or x.device != s.device:
            raise _OtherShape(
                f"{owner} {what} {i}: {tuple(x.shape)} {x.dtype} on "
                f"{x.device}, the graph holds {tuple(s.shape)} {s.dtype} on "
                f"{s.device}")
        if x is not s:
            s.copy_(x)
            nbytes += s.numel() * s.element_size()
        copied[i] = (weakref.ref(x), x._version)
    return static, nbytes


def _held(copied: list) -> list:
    """(tensor or None, version) of each entry of a `_load` record."""
    return [(ref(), version) for ref, version in copied]


# --- the cache of captured graphs ---------------------------------------------
#
# `jax.jit` compiles one program per configuration (its static arguments, the
# structure, shapes and dtypes of its array arguments) and runs any state of
# that configuration on it.  The port keeps one captured graph per
# configuration the same way: the graphs below live in a process-wide cache
# keyed by what `fn` closes over (the caller's key: configuration, device,
# the graph's kind, a mesh), the kind of graph, and the structure, plain
# values, shapes and dtypes of the state and inputs.  A `StepGraph` or
# `FrameGraph` is one run's handle on its cached graph: it holds the run's
# generator and counters; the graph, its buffers and its own generator are
# shared by every handle of the key.

CACHE_SIZE = 8   # graphs kept a device; the least recently used goes first

_cache: dict = {}          # str(device) -> OrderedDict(key -> shared graph)
_stats = {"hits": 0, "misses": 0, "captures": 0, "evicted": 0, "cleared": 0,
          "dropped": 0, "most_held": 0}


def _lookup(dev, key, make: Callable[[], Any]) -> tuple[Any, bool]:
    """(The graph cached under `key` on `dev`, True), or (`make()` now
    cached there, False).  Past CACHE_SIZE graphs on the device the least
    recently used leaves the cache: a handle that holds it keeps it."""
    held = _cache.setdefault(str(dev), collections.OrderedDict())
    shared = held.get(key)
    if shared is not None:
        held.move_to_end(key)
        _stats["hits"] += 1
        return shared, True
    _stats["misses"] += 1
    shared = held[key] = make()
    while len(held) > CACHE_SIZE:
        held.popitem(last=False)
        _stats["evicted"] += 1
    _stats["most_held"] = max(_stats["most_held"], len(held))
    return shared, False


def clear_graph_cache(device=None) -> int:
    """Drop the cache's graphs (of `device`, or of every device): the
    counterpart of `jax.clear_caches()`.  A handle that holds a graph keeps
    it; the next new state of its configuration captures anew.  Their
    branch launches are settled first.  Returns how many were dropped."""
    dropped = 0
    for dev in list(_cache):
        if device is not None and dev != str(torch.device(device)):
            continue
        for shared in _cache.pop(dev).values():
            if isinstance(shared, _FrameShared):
                shared.settle()
            dropped += 1
    _stats["cleared"] += dropped
    return dropped


def drop_graphs(mesh) -> int:
    """Drop every graph keyed on `mesh` (`parallel.mesh.Mesh.close` calls
    this before it releases the mesh's buffers, which those graphs' K8 nodes
    point into): out of the cache, its branch launches settled, its graph
    and pools released, and any handle that still holds it raises.
    Returns how many were dropped."""
    def keyed_on(shared) -> bool:
        key = shared.key if isinstance(shared.key, tuple) else (shared.key,)
        return any(part is mesh for part in key)

    dropped = 0
    for held in _cache.values():
        for key in [k for k, shared in held.items() if keyed_on(shared)]:
            del held[key]
    for shared in list(_live_frame_graphs):
        if shared.dead is None and keyed_on(shared):
            shared.settle()
            shared.dead = f"its mesh {mesh!r} was closed"
            if shared.release is not None:
                shared.release()
            dropped += 1
    _stats["dropped"] += dropped
    return dropped


def graph_cache_info() -> dict:
    """The graphs the cache holds on each device, and since the process
    started: hits, misses, captures (each a miss's; a key captures once
    until it leaves the cache), evicted, cleared and dropped graphs, and the
    most graphs a device held at once."""
    return {"held": {dev: len(held) for dev, held in _cache.items()},
            "size_per_device": CACHE_SIZE, **_stats}


def _lend(shared, generator: Optional[torch.Generator]):
    """The graph's own generator (registered with its capture) holding
    `generator`'s state, or None: the run's draws are its state's."""
    if generator is None:
        return None
    if shared.generator is None:
        shared.generator = torch.Generator(device=generator.device)
    shared.generator.set_state(generator.get_state())
    return shared.generator


def _give_back(shared, generator: Optional[torch.Generator]) -> None:
    """`generator` where the run left the graph's own: as a run on a graph
    captured with `generator` itself leaves it."""
    if generator is not None:
        generator.set_state(shared.generator.get_state())


class _Handle:
    """What a StepGraph and a FrameGraph share: a run's handle on the graph
    of its key (`key` None: a graph of its own, never cached)."""

    kind = ""

    def __init__(self, fn: Callable[..., Any],
                 generator: Optional[torch.Generator], key=None):
        self.fn, self.generator, self.key = fn, generator, key
        # this run's: calls run eagerly (the CPU; a StepGraph's warm-up),
        # captures, replays, warm-ups and graphs found in the cache
        self.eager_calls = self.captures = self.replays = 0
        self.warmups = self.cache_hits = 0
        self._shared = None

    @classmethod
    def reuse(cls, carried, fn: Callable[..., Any],
              generator: Optional[torch.Generator], key):
        """`carried` when it is a handle of this kind made for `key` that
        draws from `generator`, else a new handle (which finds the graph of
        its key in the cache at its first call).  `key` names everything
        `fn` closes over (configuration, device, kind, mesh)."""
        if (isinstance(carried, cls) and carried.key == key
                and carried.generator is generator):
            return carried
        return cls(fn, generator, key)

    def _resolve(self, spec, leaves: list):
        """The shared graph of this call's structure and shapes: the cached
        one of the key, or a new one (cached unless the key is None)."""
        sig = _signature(leaves)
        if self.key is None:
            if self._shared is None:
                self._shared = self._make(spec, sig)
            elif (spec, sig) != (self._shared.spec, self._shared.sig):
                raise ValueError(f"{type(self).__name__}: the structure or "
                                 "plain values of the inputs differ from the "
                                 "first call's")
            return self._shared
        self._shared, hit = _lookup(
            leaves[0].device, (self.kind, self.key, spec, sig),
            lambda: self._make(spec, sig))
        self.cache_hits += hit
        return self._shared

    def _bind(self, spec, leaves: list):
        shared = self._shared
        if shared is None or spec != shared.spec:
            shared = self._resolve(spec, leaves)
        if shared.dead is not None:
            raise RuntimeError(f"{type(self).__name__}: the graph is gone: "
                               f"{shared.dead}")
        return shared

    @property
    def graph(self):
        return None if self._shared is None else self._shared.graph

    @property
    def nodes(self) -> dict:
        return {} if self._shared is None else self._shared.nodes

    def cold_start(self) -> dict:
        """The host ms of the shared graph's warm-up, capture and
        instantiation (the device ms of its warm-up from its events, read
        after a wait), {} before its capture."""
        if self._shared is None or not self._shared.cold:
            return {}
        out = dict(self._shared.cold)
        events = out.pop("warmup_events", None)
        if events is not None:
            events[1].synchronize()
            out["warmup_device_ms"] = events[0].elapsed_time(events[1])
        return out


class _StepShared:
    """What every StepGraph of one key shares: `fn`, the static buffers,
    the captured graph, its nodes and its own generator."""

    def __init__(self, fn, spec, sig, key):
        self.fn, self.spec, self.sig, self.key = fn, spec, sig, key
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.nodes: dict = {}
        self.warmed = False
        self.static: Optional[list] = None
        self.copied: list = []           # (weak ref, version) last copied
        self.out_leaves: Optional[list] = None
        self.out_spec = None
        self.stream = None
        self.generator: Optional[torch.Generator] = None
        self.dead: Optional[str] = None
        self.cold: dict = {}


class StepGraph(_Handle):
    """`fn(generator, *inputs)` captured once per key and replayed per call
    (CUDA), or run eagerly through the same static buffers (CPU).  Counters
    (this run's): `eager_calls`, `captures`, `replays`, `warmups`,
    `cache_hits`; `nodes` maps each kernel wrapper to its launches in one
    replay.

    On a CUDA device, for a key not in the cache the first call runs `fn`
    eagerly on the graph's side stream with the run's generator (a real
    step, and the warm-up that builds the kernels), the second captures;
    a key already captured replays from the first call."""

    kind = "StepGraph"

    def _make(self, spec, sig):
        return _StepShared(self.fn, spec, sig, self.key)

    @property
    def _static(self):
        return None if self._shared is None else self._shared.static

    @property
    def _copied(self) -> list:
        return [] if self._shared is None else _held(self._shared.copied)

    def __call__(self, *inputs):
        span = RECORDER.begin("graph.replay")
        nbytes = 0
        try:
            leaves: list = []
            spec = _flatten(inputs, leaves)
            shared = self._bind(spec, leaves)
            while True:
                try:
                    out, nbytes = self._run(shared, leaves, inputs)
                    return out
                except _OtherShape:
                    if self.key is None:
                        raise
                    shared = self._resolve(spec, leaves)
        finally:
            RECORDER.end(span, nbytes)

    def _load(self, shared, leaves: list) -> tuple[list, int]:
        shared.static, nbytes = _load("StepGraph", leaves, shared.static,
                                      shared.copied, "input", shared.sig)
        return shared.static, nbytes

    def _run(self, shared, leaves: list, inputs: tuple) -> tuple[Any, int]:
        """(The call's outputs, the bytes copied into the buffers)."""
        if leaves[0].device.type == "cuda":
            return self._run_cuda(shared, leaves, inputs)
        static, nbytes = self._load(shared, leaves)
        generator = _lend(shared, self.generator)
        out = shared.fn(generator, *_unflatten(shared.spec, static))
        _give_back(shared, self.generator)
        self.eager_calls += 1
        out_leaves: list = []
        out_spec = _flatten(out, out_leaves)
        return _unflatten(out_spec, [x.clone() for x in out_leaves]), nbytes

    def _run_cuda(self, shared, leaves: list, inputs: tuple):
        global _recording
        current = torch.cuda.current_stream()
        if shared.stream is None:
            shared.stream = torch.cuda.Stream(device=leaves[0].device)
        if not shared.warmed:
            # the warm-up: a real step, eager, on the capture stream, with
            # the run's own generator
            t0 = time.perf_counter_ns()
            shared.stream.wait_stream(current)
            with torch.cuda.stream(shared.stream):
                out = shared.fn(self.generator, *inputs)
            current.wait_stream(shared.stream)
            shared.warmed = True
            t1 = time.perf_counter_ns()
            RECORDER.record("graph.warmup", t0, t1)
            shared.cold["warmup_ms"] = (t1 - t0) / 1e6
            self.eager_calls += 1
            self.warmups += 1
            return out, 0
        static, nbytes = self._load(shared, leaves)
        if shared.graph is None:
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                _lend(shared, self.generator)
                graph.register_generator_state(shared.generator)
            t0 = time.perf_counter_ns()
            _recording = {}
            try:
                with torch.cuda.graph(graph, stream=shared.stream,
                                      capture_error_mode="thread_local"):
                    out = shared.fn(shared.generator,
                                    *_unflatten(shared.spec, static))
                    t1 = time.perf_counter_ns()
                shared.nodes = _recording
            finally:
                _recording = None
            # torch.cuda.graph ends the capture and instantiates as one step
            t2 = time.perf_counter_ns()
            RECORDER.record("graph.capture", t0, t1)
            RECORDER.record("graph.instantiate", t1, t2)
            shared.cold["capture_and_instantiate_ms"] = (t2 - t0) / 1e6
            shared.out_leaves = []
            shared.out_spec = _flatten(out, shared.out_leaves)
            shared.graph = graph
            self.captures += 1
            _stats["captures"] += 1
        _lend(shared, self.generator)
        shared.graph.replay()
        _give_back(shared, self.generator)
        self.replays += 1
        for wrapper, k in shared.nodes.items():
            wrapper.launches += k
        return _unflatten(shared.out_spec,
                          [x.clone() for x in shared.out_leaves]), nbytes


# --- branches on the device -------------------------------------------------

def in_graph() -> bool:
    """True while a FrameGraph captures its step or warms it up: a branch's
    predicate stays on the device and its body writes its results in place."""
    return _warming or _frame_capture is not None


def branch_values(*values):
    """What a host branch needs to know: in a FrameGraph's capture or warm-up
    the 0-dim device tensors themselves (each `cond` reads its predicate on
    the device), else their values as host ints (a bool as 0 or 1), fetched
    together: one wait on a CUDA device."""
    if in_graph():
        return values
    return torch.stack([torch.as_tensor(v).reshape(()).to(torch.int64)
                        for v in values]).tolist()


_cond_fns: dict = {}


def _cond_library():
    """graph_cond_begin / graph_cond_end of `csrc/graph_cond.cu`, built and
    loaded at the first capture."""
    if not _cond_fns:
        from jetracer_orbslam2_torch.utils import cuda_build

        lib = cuda_build.load_library("graph_cond")
        ptr = ctypes.c_void_p
        lib.graph_cond_begin.argtypes = [ptr, ptr, ptr]
        lib.graph_cond_end.argtypes = [ptr]
        lib.graph_capture_node_types.argtypes = [
            ptr, ctypes.POINTER(ctypes.c_int), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.graph_body_mark.argtypes = [ptr, ptr, ptr, ctypes.c_int,
                                        ctypes.c_int]
        for fn in (lib.graph_cond_setup, lib.graph_cond_begin,
                   lib.graph_cond_end, lib.graph_capture_node_types,
                   lib.graph_body_mark):
            fn.restype = ctypes.c_int
        err = lib.graph_cond_setup()
        if err != 0:
            raise RuntimeError(f"graph_cond setup failed: cudaError {err}")
        _cond_fns.update(begin=lib.graph_cond_begin, end=lib.graph_cond_end,
                         types=lib.graph_capture_node_types,
                         mark=lib.graph_body_mark)
    return _cond_fns["begin"], _cond_fns["end"]


def _body_mark(stream, marks: Tensor, elapsed: Tensor, index: int,
               last: bool) -> None:
    """A one-thread kernel node on `stream` (capturing a body) that reads
    the device's clock: at the body's first edge it keeps the time in
    `marks[index]`, at its last it adds the time since to `elapsed[index]`."""
    err = _cond_fns["mark"](stream.cuda_stream, marks.data_ptr(),
                            elapsed.data_ptr(), index, int(last))
    if err != 0:
        raise RuntimeError(f"graph_body_mark failed: cudaError {err}")


# cudaGraphNodeType, in the runtime's order
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def _captured_node_types(stream) -> dict:
    """The nodes `stream` has captured into its graph so far, counted by
    type (a nested `if` node is one `conditional` node of its parent)."""
    count = ctypes.c_size_t(0)
    err = _cond_fns["types"](stream.cuda_stream, None, 0, ctypes.byref(count))
    types = (ctypes.c_int * max(count.value, 1))()
    if err == 0:
        err = _cond_fns["types"](stream.cuda_stream, types, count.value,
                                 ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"graph_capture_node_types failed: cudaError {err}")
    out: dict = {}
    for t in types[:count.value]:
        name = (NODE_TYPES[t] if 0 <= t < len(NODE_TYPES)
                else "unknown" if t < 0 else f"type {t}")
        out[name] = out.get(name, 0) + 1
    return out


def _host_body(body: Callable[[], None], name: str) -> None:
    """`body()` as a host branch, a span `graph.body.<name>` whose value is
    its host ns."""
    span = RECORDER.begin("graph.body." + name)
    t0 = time.perf_counter_ns()
    try:
        body()
    finally:
        RECORDER.end(span, time.perf_counter_ns() - t0)


def cond(pred, body: Callable[[], None], name: str = "body") -> None:
    """Run `body()` where `pred` holds: the port's `lax.cond`.  A body returns
    nothing; it writes its results into tensors that exist before it (in a
    FrameGraph, the carried state's buffers), so a body not taken leaves
    them as they were.

    pred: a host value (`branch_values` gives one outside a graph): a host
    `if`.  A () bool tensor while a FrameGraph captures: an `if` node of the
    graph on the tensor; during its warm-up: the body runs, whatever pred
    holds.  A CPU tensor: a host `if`.  A CUDA tensor anywhere else raises:
    reading it would make the host wait.

    name: the body's, for its time.  A host branch taken is a span
    `graph.body.<name>` of the recorder (host ns as its value); in a
    FrameGraph the body's device ns are counted with its replays
    (`FrameGraph.branch_counts`)."""
    if not isinstance(pred, Tensor):
        if pred:
            _host_body(body, name)
        return
    if _warming:
        body()
        return
    if _frame_capture is not None:
        _frame_capture.record_if(pred, body, name)
        return
    if pred.device.type != "cpu":
        raise ValueError("cond: a device predicate outside a FrameGraph "
                         "capture (fetch it with branch_values)")
    if bool(pred):
        _host_body(body, name)


class Carry:
    """State a step rewrites, its fields read as attributes and rewritten by
    `set`.  In place (each new value copied into the tensor the field held,
    a field the value already is left alone) where the tensors are a
    graph's buffers and a `cond` body's writes must land in them, so that a
    body not taken leaves them as they were; else by rebinding, which
    leaves the tensors the caller handed in untouched.  A field may be a
    tuple of tensors (a NamedTuple such as MapState)."""

    def __init__(self, fields: dict, in_place: bool):
        self.__dict__.update(fields=dict(fields), in_place=in_place)

    def __getattr__(self, name):
        return self.fields[name]

    def set(self, **fields) -> None:
        for name, value in fields.items():
            if not self.in_place:
                self.fields[name] = value
                continue
            old = self.fields[name]
            for o, v in (zip(old, value) if isinstance(old, tuple)
                         else ((old, value),)):
                if v is not o:
                    o.copy_(v)


MAX_BODIES = 8
_POOL_MOVE = ("_cuda_beginAllocateCurrentStreamToPool", "_cuda_endAllocateToPool")


class _Capture:
    """A FrameGraph capture in progress: its `if` nodes in the order they
    were recorded, each with its name and the kernel launches of its body,
    the streams bodies are captured on (one a nesting depth) and the memory
    pools their allocations went to (held until the graph goes).  Each body
    opens and closes with a clock mark that adds its device ns to
    `elapsed` (`marks` keeps its start)."""

    def __init__(self, taken: Tensor, marks: Tensor, elapsed: Tensor,
                 streams: list):
        self.taken, self.streams = taken, streams
        self.marks, self.elapsed = marks, elapsed
        self.names: list[str] = []
        self.bodies: list[dict] = []
        self.body_nodes: list[int] = []    # graph nodes of each body
        self.body_types: list[dict] = []   # ... counted by node type
        self.pools: list = []
        self.depth = 0

    def record_if(self, pred: Tensor, body: Callable[[], None],
                  name: str) -> None:
        global _recording
        if len(self.bodies) == MAX_BODIES:
            raise ValueError(f"FrameGraph: more than {MAX_BODIES} branches")
        if self.depth == len(self.streams):
            raise ValueError(f"FrameGraph: branches nested deeper than "
                             f"{len(self.streams)}")
        begin, end = _cond_library()
        dev = pred.device
        p = pred.reshape(()).to(torch.bool).contiguous()
        outer = torch.cuda.current_stream(dev)
        inner = self.streams[self.depth]
        index, nodes = len(self.bodies), {}
        self.names.append(name)
        self.bodies.append(nodes)
        self.body_nodes.append(0)
        self.body_types.append({})
        # the body's allocations go to a pool of its own: the stream it is
        # captured on is not the graph's, whose pool takes only that stream
        pool = torch.cuda.graph_pool_handle()
        self.pools.append(pool)
        err = begin(outer.cuda_stream, p.data_ptr(), inner.cuda_stream)
        if err != 0:
            raise RuntimeError(f"graph_cond_begin failed: cudaError {err}")
        saved, _recording = _recording, nodes
        self.depth += 1
        try:
            with torch.cuda.stream(inner):
                # a body's work must see the capture: `note_launch` records
                # the body's kernels by it
                if not torch.cuda.is_current_stream_capturing():
                    raise RuntimeError("FrameGraph: a branch's stream is not "
                                       "capturing")
                getattr(torch._C, _POOL_MOVE[0])(dev.index, pool)
                try:
                    _body_mark(inner, self.marks, self.elapsed, index, False)
                    self.taken[index].fill_(True)
                    body()
                    _body_mark(inner, self.marks, self.elapsed, index, True)
                    types = _captured_node_types(inner)
                    self.body_types[index] = types
                    self.body_nodes[index] = sum(types.values())
                finally:
                    getattr(torch._C, _POOL_MOVE[1])(dev.index, pool)
        finally:
            self.depth -= 1
            _recording = saved
            err = end(inner.cuda_stream)
        if err != 0:
            raise RuntimeError(f"graph_cond_end failed: cudaError {err}; "
                               f"{self.describe()}")

    def describe(self) -> str:
        """Each body's nodes by type, for the message of a refused capture."""
        return "branch nodes by type: " + "; ".join(
            f"{i}: {t}" for i, t in enumerate(self.body_types))


def _release(graph, dev_index: int, pools: list) -> None:
    graph.reset()
    for pool in pools:
        torch._C._cuda_releasePool(dev_index, pool)


# every FrameGraph's shared graph alive (cached, or held by a handle)
_live_frame_graphs: "weakref.WeakSet[_FrameShared]" = weakref.WeakSet()


class _FrameShared:
    """What every FrameGraph of one key shares: `fn`, the carried state's
    and the inputs' buffers, the captured graph with its branches, its
    counts of the branches taken and its own generator."""

    def __init__(self, fn, spec, sig, key):
        self.fn, self.spec, self.sig, self.key = fn, spec, sig, key
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.nodes: dict = {}
        self.body_names: list[str] = []
        self.bodies: list[dict] = []
        self.graph_nodes = 0             # graph nodes of the frame, bodies aside
        self.body_nodes: list[int] = []  # graph nodes of each body
        self.body_types: list[dict] = []  # ... counted by node type
        self.carry: Optional[list] = None
        self.carry_copied: list = []
        self.inputs: Optional[list] = None
        self.in_copied: list = []
        self.out_leaves: Optional[list] = None
        self.out_spec = None
        self.stream = None
        self.taken: Optional[Tensor] = None     # (MAX_BODIES,) this replay's
        self.totals: Optional[Tensor] = None    # replays that took each body
        self.elapsed: Optional[Tensor] = None   # ... and their device ns
        self.marks: Optional[Tensor] = None     # each body's start, device ns
        self.unsettled = False
        self.generator: Optional[torch.Generator] = None
        self.dead: Optional[str] = None
        self.release = None              # releases the graph and its pools
        self.cold: dict = {}
        _live_frame_graphs.add(self)

    def carried(self):
        return _unflatten(self.spec[0], self.carry)

    def counts(self) -> Tensor:
        """(2, bodies) int64 on the device: the replays that took each body
        since the last settle, and their device ns."""
        n = len(self.bodies)
        return torch.stack([self.totals[:n], self.elapsed[:n]])

    def settle(self, counts=None) -> None:
        if not self.unsettled:
            return
        if counts is None:
            counts = self.counts().cpu()
        self.totals.zero_()
        self.elapsed.zero_()
        self.unsettled = False
        for taken, nodes in zip(np.asarray(counts)[0].tolist(), self.bodies):
            for wrapper, k in nodes.items():
                wrapper.launches += k * int(taken)

    def capture(self, dev, generator: Optional[torch.Generator]) -> None:
        """Warm up on a copy of the state, then capture `fn` on the buffers
        with the graph's own generator registered (loaded with the run's
        state: `_lend`)."""
        global _warming, _frame_capture, _recording
        current = torch.cuda.current_stream(dev)
        self.stream = torch.cuda.Stream(device=dev)
        streams = [torch.cuda.Stream(device=dev) for _ in range(3)]
        self.taken = torch.zeros(MAX_BODIES, dtype=torch.bool, device=dev)
        self.totals = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        self.elapsed = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        self.marks = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        inputs = _unflatten(self.spec[1], self.inputs)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter_ns()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            events[0].record()
            scratch = torch.Generator(device=dev)
            scratch.manual_seed(0)
            warm = _unflatten(self.spec[0], [x.clone() for x in self.carry])
            _warming = True
            try:
                self.fn(scratch, warm, *inputs)
            finally:
                _warming = False
            del warm
            events[1].record()
        for s in streams:            # each body stream's library workspace
            with torch.cuda.stream(s):
                torch.cuda.current_blas_handle()
        current.wait_stream(self.stream)
        _cond_library()
        t1 = time.perf_counter_ns()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            _lend(self, generator)
            graph.register_generator_state(self.generator)
        cap = _Capture(self.taken, self.marks, self.elapsed, streams)
        enabled = gc.isenabled()
        gc.disable()                 # no finalizer may run inside a capture
        _frame_capture, _recording = cap, {}
        try:
            # capture_begin / capture_end, not `torch.cuda.graph`, whose
            # entry synchronizes the device: the capture makes no host wait
            with torch.cuda.stream(self.stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.taken.zero_()
                    out = self.fn(self.generator, self.carried(), *inputs)
                    self.totals.add_(self.taken)
                    self.graph_nodes = sum(
                        _captured_node_types(self.stream).values())
                finally:
                    t2 = time.perf_counter_ns()
                    try:
                        graph.capture_end()     # instantiates the graph
                    except RuntimeError as e:
                        raise RuntimeError(f"{e}; {cap.describe()}") from e
            current.wait_stream(self.stream)
            self.nodes = _recording
        finally:
            _frame_capture, _recording = None, None
            if enabled:
                gc.enable()
        t3 = time.perf_counter_ns()
        for name, a, b in (("graph.warmup", t0, t1), ("graph.capture", t1, t2),
                           ("graph.instantiate", t2, t3)):
            RECORDER.record(name, a, b)
        self.body_names, self.bodies = cap.names, cap.bodies
        self.body_nodes, self.body_types = cap.body_nodes, cap.body_types
        self.out_leaves = []
        self.out_spec = _flatten(out, self.out_leaves)
        self.graph = graph
        self.cold = {"warmup_ms": (t1 - t0) / 1e6, "capture_ms": (t2 - t1) / 1e6,
                     "instantiate_ms": (t3 - t2) / 1e6, "warmup_events": events}
        self.release = weakref.finalize(self, _release, graph, dev.index,
                                        cap.pools)
        _stats["captures"] += 1


class FrameGraph(_Handle):
    """`fn(generator, carry, *inputs)`, a step that reads the carried state
    `carry` (a tree of tensors), rewrites it in place and returns the step's
    outputs, with `cond` for its branches: captured once per key and
    replayed per call on a CUDA device, run on the same buffers on the CPU.

    The carried state lives in the graph's buffers (`carry`): a call copies
    in only a state that is not the one these buffers hold (another tensor,
    or one changed in place since: another state of the configuration is
    copied in whole), and `export` hands the state out as a copy.  Outputs
    are copies.  Counters (this run's): `eager_calls` (CPU), `captures`,
    `replays`, `warmups`, `cache_hits`, `state_bytes_in` (the bytes of
    state copied into the buffers); `nodes` maps each kernel wrapper to its
    launches in every replay, `bodies` holds each branch's in capture order
    and `body_names` their names (`cond`'s `name`); `graph_nodes` and
    `body_nodes` count the graph's nodes (a branch is one node of the graph
    that holds it, and its body's nodes, its two clock marks among them,
    are counted apart).

    The first CUDA call of a key not in the cache warms up: `fn` runs once
    on a copy of the state with a generator of its own and every branch
    taken (it builds each kernel, fills each cached constant and library
    handle; it is thrown away and counts no launch), then captures `fn` and
    replays it.  A capture that fails raises; there is no eager fallback.
    The run's draws are the replays': the graph's own generator holds the
    run's generator's state for each replay and hands it back after, and
    no draw may sit inside a branch (a replay advances the generator by the
    whole graph's draws, taken or not)."""

    kind = "FrameGraph"

    def __init__(self, fn: Callable[..., Any],
                 generator: Optional[torch.Generator], key=None):
        super().__init__(fn, generator, key)
        self.state_bytes_in = 0

    def _make(self, spec, sig):
        return _FrameShared(self.fn, spec, sig, self.key)

    # what the shared graph recorded at its capture
    @property
    def body_names(self) -> list:
        return [] if self._shared is None else self._shared.body_names

    @property
    def bodies(self) -> list:
        return [] if self._shared is None else self._shared.bodies

    @property
    def graph_nodes(self) -> int:
        return 0 if self._shared is None else self._shared.graph_nodes

    @property
    def body_nodes(self) -> list:
        return [] if self._shared is None else self._shared.body_nodes

    @property
    def body_types(self) -> list:
        return [] if self._shared is None else self._shared.body_types

    @property
    def _carry(self):
        return None if self._shared is None else self._shared.carry

    @property
    def _carry_copied(self) -> list:
        return [] if self._shared is None else _held(self._shared.carry_copied)

    def carry(self):
        """The carried state as the graph's buffers hold it (not a copy)."""
        return self._shared.carried()

    def export(self):
        """A copy of the carried state; handed back to the next call it is
        not copied in again (unless changed in place meanwhile)."""
        shared = self._shared
        out = [x.clone() for x in shared.carry]
        shared.carry_copied = [(weakref.ref(x), x._version) for x in out]
        return _unflatten(shared.spec[0], out)

    def __call__(self, carry, *inputs):
        span = RECORDER.begin("graph.replay")
        nbytes = 0
        try:
            out, nbytes = self._call(carry, inputs)
            return out
        finally:
            RECORDER.end(span, nbytes)

    def _call(self, carry, inputs: tuple) -> tuple[Any, int]:
        """(The step's outputs, the bytes of state and inputs copied into
        the buffers)."""
        c_leaves: list = []
        c_spec = _flatten(carry, c_leaves)
        i_leaves: list = []
        i_spec = _flatten(inputs, i_leaves)
        spec, leaves = (c_spec, i_spec), c_leaves + i_leaves
        shared = self._bind(spec, leaves)
        n = len(c_leaves)
        while True:
            try:
                shared.carry, state_bytes = _load(
                    "FrameGraph", c_leaves, shared.carry, shared.carry_copied,
                    "state", shared.sig[:n])
                shared.inputs, input_bytes = _load(
                    "FrameGraph", i_leaves, shared.inputs, shared.in_copied,
                    "input", shared.sig[n:])
                break
            except _OtherShape:
                if self.key is None:
                    raise
                shared = self._resolve(spec, leaves)
        self.state_bytes_in += state_bytes
        dev = c_leaves[0].device
        if dev.type == "cuda":
            if shared.graph is None:
                shared.capture(dev, self.generator)
                self.captures += 1
                self.warmups += 1
            # the replay runs on the caller's stream, after its copies in
            _lend(shared, self.generator)
            shared.graph.replay()
            _give_back(shared, self.generator)
            self.replays += 1
            for wrapper, k in shared.nodes.items():
                wrapper.launches += k
            shared.unsettled = bool(shared.bodies)
            out = _unflatten(shared.out_spec,
                             [x.clone() for x in shared.out_leaves])
        else:
            generator = _lend(shared, self.generator)
            res = shared.fn(generator, shared.carried(),
                            *_unflatten(shared.spec[1], shared.inputs))
            _give_back(shared, self.generator)
            self.eager_calls += 1
            leaves = []
            out = _unflatten(_flatten(res, leaves),
                             [x.clone() for x in leaves])
        # the buffers hold the state this call left: handed back, they are
        # not copied in again
        shared.carry_copied = [(weakref.ref(x), x._version)
                               for x in shared.carry]
        return out, state_bytes + input_bytes

    def branch_counts(self) -> Optional[Tensor]:
        """(2, bodies) int64 on the device, bodies in capture order
        (`body_names`): how many replays of the graph since the last
        `settle` took each branch (row 0), and the device ns those bodies
        took (row 1, each body's time including the bodies inside it).
        None when there is nothing to count."""
        shared = self._shared
        if shared is None or not shared.unsettled:
            return None
        return shared.counts()

    def settle(self, counts=None) -> None:
        """Add each branch's kernel launches once for every replay that took
        it, and start counting (and timing) again.  counts: `branch_counts()`
        already fetched with the caller's outputs (host values), else
        fetched here (one wait)."""
        if self._shared is not None:
            self._shared.settle(counts)


def settle_launches() -> None:
    """Settle every live FrameGraph's branch launches (see
    `FrameGraph.settle`; one wait a graph replayed since): what a reader of
    the `launches` counters calls first."""
    for shared in list(_live_frame_graphs):
        shared.settle()


def fetch(*tensors) -> list:
    """Tensors of any dtypes and shapes as numpy arrays, through ONE copy
    to the host: their bytes packed into one buffer on their device."""
    if not tensors:
        return []
    flat = [t.contiguous().reshape(-1) for t in tensors]
    raw = torch.cat([t.view(torch.uint8) if t.dtype != torch.bool
                     else t.to(torch.uint8) for t in flat]).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        nbytes = f.numel() * f.element_size()
        chunk = raw[at:at + nbytes]
        at += nbytes
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        out.append(chunk.view(dtype).reshape(tuple(t.shape)))
    return out
