"""A fixed-shape step captured once into a CUDA graph and replayed each call.

The JAX package compiles its frame step once (`jit`, `lax.scan`) and
dispatches it once a frame.  The port's counterpart is a CUDA graph:
`StepGraph(fn, generator)` wraps `fn(generator, *inputs)`, whose inputs and
outputs are tensors or (named) tuples of tensors of fixed shapes.

On a CUDA device:
  * the first call runs `fn` eagerly on the graph's side stream, with the
    run's generator: it is a real step (its draws are the run's) and the
    warm-up that builds the kernels and fills every cached constant;
  * the second call copies its inputs into static buffers, captures `fn` on
    them with the generator registered with the graph
    (`CUDAGraph.register_generator_state`), and replays it; every later call
    copies the inputs that changed into the buffers and replays.  A replay
    advances the generator as an eager step would, so eager draws between
    replays keep their order;
  * outputs are cloned out of the graph's pool, which the next replay
    overwrites.  A capture that fails raises; there is no eager fallback.

On the CPU every call runs `fn` eagerly through the same static buffers, so
the tests exercise the copies in and out.

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
"""

from __future__ import annotations

import ctypes
import gc
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch

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
    each tensor replaced by its index (None and plain values kept)."""
    if isinstance(tree, Tensor):
        leaves.append(tree)
        return len(leaves) - 1
    if isinstance(tree, tuple):
        items = [_flatten(x, leaves) for x in tree]
        return ("tuple", type(tree), items)
    if isinstance(tree, list):
        return ("list", list, [_flatten(x, leaves) for x in tree])
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


def _load(owner: str, leaves: list, static: Optional[list], copied: list,
          what: str) -> list:
    """The static buffers holding `leaves`: made at the first call (copies),
    then each leaf copied in only when it is another tensor than the one
    copied last time, or the same tensor modified in place since (its
    version counter moved).  `copied` holds (tensor, version) of each."""
    if static is None:
        copied[:] = [(x, x._version) for x in leaves]
        return [x.clone() for x in leaves]
    if len(leaves) != len(static):
        raise ValueError(f"{owner}: {len(leaves)} {what} tensors, the graph "
                         f"has {len(static)}")
    for i, (x, s) in enumerate(zip(leaves, static)):
        last, version = copied[i]
        if last is x and x._version == version:
            continue
        if x.shape != s.shape or x.dtype != s.dtype or x.device != s.device:
            raise ValueError(
                f"{owner} {what} {i}: {tuple(x.shape)} {x.dtype} on "
                f"{x.device}, the graph holds {tuple(s.shape)} {s.dtype} on "
                f"{s.device}")
        s.copy_(x)
        copied[i] = (x, x._version)
    return static


class StepGraph:
    """`fn(generator, *inputs)` captured once and replayed per call (CUDA),
    or run eagerly through the same static buffers (CPU).  Counters:
    `eager_calls`, `captures`, `replays`; `nodes` maps each kernel wrapper
    to its launches in one replay."""

    def __init__(self, fn: Callable[..., Any],
                 generator: Optional[torch.Generator], key=None):
        self.fn = fn
        self.generator = generator
        self.key = key
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.nodes: dict = {}
        self.eager_calls = self.captures = self.replays = 0
        self._spec = None
        self._static: Optional[list] = None
        self._copied: list = []          # (tensor, version) last copied
        self._out_leaves: Optional[list] = None
        self._out_spec = None
        self._stream = None

    @classmethod
    def reuse(cls, carried: Optional["StepGraph"], fn: Callable[..., Any],
              generator: Optional[torch.Generator], key) -> "StepGraph":
        """`carried` when it was made for `key` and draws from `generator`,
        else a new graph of `fn` (captured at its second call): how a caller
        keeps one graph across calls.  `key` names everything `fn` closes
        over (configuration, shapes, device)."""
        if (carried is not None and carried.key == key
                and carried.generator is generator):
            return carried
        return cls(fn, generator, key)

    def __call__(self, *inputs):
        leaves: list = []
        spec = _flatten(inputs, leaves)
        if self._spec is None:
            self._spec = spec
        elif spec != self._spec:
            raise ValueError("StepGraph: the inputs' structure or plain "
                             "values differ from the first call's")
        dev = leaves[0].device
        if dev.type == "cuda":
            return self._call_cuda(leaves, inputs)
        self._static = _load("StepGraph", leaves, self._static, self._copied,
                             "input")
        out = self.fn(self.generator, *_unflatten(self._spec, self._static))
        self.eager_calls += 1
        out_leaves: list = []
        out_spec = _flatten(out, out_leaves)
        return _unflatten(out_spec, [x.clone() for x in out_leaves])

    def _call_cuda(self, leaves: list, inputs: tuple):
        global _recording
        current = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=leaves[0].device)
        if self.eager_calls == 0 and self.graph is None:
            # the warm-up: a real step, eager, on the capture stream
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = self.fn(self.generator, *inputs)
            current.wait_stream(self._stream)
            self.eager_calls += 1
            return out
        self._static = _load("StepGraph", leaves, self._static, self._copied,
                             "input")
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            _recording = {}
            try:
                with torch.cuda.graph(graph, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    out = self.fn(self.generator,
                                  *_unflatten(self._spec, self._static))
                self.nodes = _recording
            finally:
                _recording = None
            self._out_leaves = []
            self._out_spec = _flatten(out, self._out_leaves)
            self.graph = graph
            self.captures += 1
        self.graph.replay()
        self.replays += 1
        for wrapper, k in self.nodes.items():
            wrapper.launches += k
        return _unflatten(self._out_spec,
                          [x.clone() for x in self._out_leaves])


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
        for fn in (lib.graph_cond_setup, lib.graph_cond_begin,
                   lib.graph_cond_end, lib.graph_capture_node_types):
            fn.restype = ctypes.c_int
        err = lib.graph_cond_setup()
        if err != 0:
            raise RuntimeError(f"graph_cond setup failed: cudaError {err}")
        _cond_fns.update(begin=lib.graph_cond_begin, end=lib.graph_cond_end,
                         types=lib.graph_capture_node_types)
    return _cond_fns["begin"], _cond_fns["end"]


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


def cond(pred, body: Callable[[], None]) -> None:
    """Run `body()` where `pred` holds: the port's `lax.cond`.  A body returns
    nothing; it writes its results into tensors that exist before it (in a
    FrameGraph, the carried state's buffers), so a body not taken leaves
    them as they were.

    pred: a host value (`branch_values` gives one outside a graph): a host
    `if`.  A () bool tensor while a FrameGraph captures: an `if` node of the
    graph on the tensor; during its warm-up: the body runs, whatever pred
    holds.  A CPU tensor: a host `if`.  A CUDA tensor anywhere else raises:
    reading it would make the host wait."""
    if not isinstance(pred, Tensor):
        if pred:
            body()
        return
    if _warming:
        body()
        return
    if _frame_capture is not None:
        _frame_capture.record_if(pred, body)
        return
    if pred.device.type != "cpu":
        raise ValueError("cond: a device predicate outside a FrameGraph "
                         "capture (fetch it with branch_values)")
    if bool(pred):
        body()


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
    were recorded, each with the kernel launches of its body, the streams
    bodies are captured on (one a nesting depth) and the memory pools their
    allocations went to (held until the graph goes)."""

    def __init__(self, taken: Tensor, streams: list):
        self.taken, self.streams = taken, streams
        self.bodies: list[dict] = []
        self.body_nodes: list[int] = []    # graph nodes of each body
        self.body_types: list[dict] = []   # ... counted by node type
        self.pools: list = []
        self.depth = 0

    def record_if(self, pred: Tensor, body: Callable[[], None]) -> None:
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
                    self.taken[index].fill_(True)
                    body()
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


_live_frame_graphs: "weakref.WeakSet[FrameGraph]" = weakref.WeakSet()


class FrameGraph:
    """`fn(generator, carry, *inputs)`, a step that reads the carried state
    `carry` (a tree of tensors), rewrites it in place and returns the step's
    outputs, with `cond` for its branches: captured once and replayed per
    call on a CUDA device, run on the same buffers on the CPU.

    The carried state lives in the graph's buffers (`carry`): a call copies
    in only a state that is not the one these buffers hold (another tensor,
    or one changed in place since), and `export` hands the state out as a
    copy.  Outputs are copies.  Counters: `eager_calls` (CPU), `captures`,
    `replays`; `nodes` maps each kernel wrapper to its launches in every
    replay, `bodies` holds each branch's in capture order; `graph_nodes`
    and `body_nodes` count the graph's nodes (a branch is one node of the
    graph that holds it, and its body's nodes are counted apart).

    The first CUDA call warms up: `fn` runs once on a copy of the state with
    a generator of its own and every branch taken (it builds each kernel,
    fills each cached constant and library handle; it is thrown away and
    counts no launch), then captures `fn` with the run's generator and
    replays it.  A capture that fails raises; there is no eager fallback.
    The run's draws are the replays': no draw may sit inside a branch (a
    replay advances the generator by the whole graph's draws, taken or not)."""

    def __init__(self, fn: Callable[..., Any],
                 generator: Optional[torch.Generator], key=None):
        self.fn, self.generator, self.key = fn, generator, key
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.nodes: dict = {}
        self.bodies: list[dict] = []
        self.graph_nodes = 0           # graph nodes of the frame, bodies aside
        self.body_nodes: list[int] = []  # graph nodes of each body
        self.body_types: list[dict] = []  # ... counted by node type
        self.eager_calls = self.captures = self.replays = 0
        self._carry_spec = self._in_spec = None
        self._carry: Optional[list] = None
        self._carry_copied: list = []
        self._in: Optional[list] = None
        self._in_copied: list = []
        self._out_leaves: Optional[list] = None
        self._out_spec = None
        self._stream = None
        self._taken: Optional[Tensor] = None     # (MAX_BODIES,) this replay's
        self._totals: Optional[Tensor] = None    # replays that took each body
        self._unsettled = False
        _live_frame_graphs.add(self)

    @classmethod
    def reuse(cls, carried, fn: Callable[..., Any],
              generator: Optional[torch.Generator], key) -> "FrameGraph":
        """`carried` when it is a FrameGraph made for `key` that draws from
        `generator`, else a new one."""
        if (isinstance(carried, cls) and carried.key == key
                and carried.generator is generator):
            return carried
        return cls(fn, generator, key)

    def carry(self):
        """The carried state as the graph's buffers hold it (not a copy)."""
        return _unflatten(self._carry_spec, self._carry)

    def export(self):
        """A copy of the carried state; handed back to the next call it is
        not copied in again (unless changed in place meanwhile)."""
        out = [x.clone() for x in self._carry]
        self._carry_copied = [(x, x._version) for x in out]
        return _unflatten(self._carry_spec, out)

    def __call__(self, carry, *inputs):
        c_leaves: list = []
        c_spec = _flatten(carry, c_leaves)
        i_leaves: list = []
        i_spec = _flatten(inputs, i_leaves)
        if self._carry_spec is None:
            self._carry_spec, self._in_spec = c_spec, i_spec
        elif c_spec != self._carry_spec or i_spec != self._in_spec:
            raise ValueError("FrameGraph: the structure or plain values of "
                             "the state or the inputs differ from the first "
                             "call's")
        self._carry = _load("FrameGraph", c_leaves, self._carry,
                            self._carry_copied, "state")
        self._in = _load("FrameGraph", i_leaves, self._in, self._in_copied,
                         "input")
        if c_leaves[0].device.type == "cuda":
            return self._call_cuda(c_leaves[0].device)
        out = self.fn(self.generator, self.carry(),
                      *_unflatten(self._in_spec, self._in))
        self._carry_copied = [(x, x._version) for x in self._carry]
        self.eager_calls += 1
        leaves: list = []
        spec = _flatten(out, leaves)
        return _unflatten(spec, [x.clone() for x in leaves])

    def _call_cuda(self, dev):
        if self.graph is None:
            self._capture(dev)
        # the replay runs on the caller's stream, after its copies in
        self.graph.replay()
        self.replays += 1
        for wrapper, k in self.nodes.items():
            wrapper.launches += k
        self._unsettled = bool(self.bodies)
        return _unflatten(self._out_spec, [x.clone() for x in self._out_leaves])

    def _capture(self, dev) -> None:
        global _warming, _frame_capture, _recording
        current = torch.cuda.current_stream(dev)
        self._stream = torch.cuda.Stream(device=dev)
        streams = [torch.cuda.Stream(device=dev) for _ in range(3)]
        self._taken = torch.zeros(MAX_BODIES, dtype=torch.bool, device=dev)
        self._totals = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        inputs = _unflatten(self._in_spec, self._in)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            scratch = torch.Generator(device=dev)
            scratch.manual_seed(0)
            warm = _unflatten(self._carry_spec, [x.clone() for x in self._carry])
            _warming = True
            try:
                self.fn(scratch, warm, *inputs)
            finally:
                _warming = False
            del warm
        for s in streams:            # each body stream's library workspace
            with torch.cuda.stream(s):
                torch.cuda.current_blas_handle()
        current.wait_stream(self._stream)
        _cond_library()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        cap = _Capture(self._taken, streams)
        enabled = gc.isenabled()
        gc.disable()                 # no finalizer may run inside a capture
        _frame_capture, _recording = cap, {}
        try:
            # capture_begin / capture_end, not `torch.cuda.graph`, whose
            # entry synchronizes the device: the capture makes no host wait
            with torch.cuda.stream(self._stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._taken.zero_()
                    out = self.fn(self.generator, self.carry(), *inputs)
                    self._totals.add_(self._taken)
                    self.graph_nodes = sum(
                        _captured_node_types(self._stream).values())
                finally:
                    try:
                        graph.capture_end()     # instantiates the graph
                    except RuntimeError as e:
                        raise RuntimeError(f"{e}; {cap.describe()}") from e
            current.wait_stream(self._stream)
            self.nodes = _recording
        finally:
            _frame_capture, _recording = None, None
            if enabled:
                gc.enable()
        self.bodies, self.body_nodes = cap.bodies, cap.body_nodes
        self.body_types = cap.body_types
        self._out_leaves = []
        self._out_spec = _flatten(out, self._out_leaves)
        self.graph = graph
        self.captures += 1
        weakref.finalize(self, _release, graph, dev.index, cap.pools)

    def branch_counts(self) -> Optional[Tensor]:
        """(bodies,) int64 on the device: how many replays since the last
        `settle` took each branch, in capture order (None when there is
        nothing to count)."""
        if not self._unsettled:
            return None
        return self._totals[:len(self.bodies)].clone()

    def settle(self, counts=None) -> None:
        """Add each branch's kernel launches once for every replay that took
        it, and start counting again.  counts: `branch_counts()` already
        fetched with the caller's outputs (host values), else fetched here
        (one wait)."""
        if not self._unsettled:
            return
        if counts is None:
            counts = self.branch_counts().cpu()
        self._totals.zero_()
        self._unsettled = False
        for taken, nodes in zip(np.asarray(counts).tolist(), self.bodies):
            for wrapper, k in nodes.items():
                wrapper.launches += k * int(taken)


def settle_launches() -> None:
    """Settle every live FrameGraph's branch launches (see
    `FrameGraph.settle`; one wait a graph replayed since): what a reader of
    the `launches` counters calls first."""
    for g in list(_live_frame_graphs):
        g.settle()


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
