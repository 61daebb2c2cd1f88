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
    replays (relocalization, loop verification) keep their order;
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
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

Tensor = torch.Tensor

# wrapper -> calls made during the StepGraph capture in progress
_recording: Optional[dict] = None


def note_launch(wrapper) -> None:
    """Count one launch of the kernel behind `wrapper` (a function with a
    `launches` attribute), called by the wrapper right after it launched on
    the current stream."""
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

    def _check(self, leaves: list) -> None:
        if len(leaves) != len(self._static):
            raise ValueError(f"StepGraph: {len(leaves)} input tensors, the "
                             f"graph has {len(self._static)}")
        for i, (x, s) in enumerate(zip(leaves, self._static)):
            if x.shape != s.shape or x.dtype != s.dtype or x.device != s.device:
                raise ValueError(
                    f"StepGraph input {i}: {tuple(x.shape)} {x.dtype} on "
                    f"{x.device}, the graph holds {tuple(s.shape)} {s.dtype} "
                    f"on {s.device}")

    def _fill(self, leaves: list) -> None:
        """Copy each input that changed since it was last copied."""
        if self._static is None:
            self._static = [x.clone() for x in leaves]
            self._copied = [(x, x._version) for x in leaves]
            return
        self._check(leaves)
        for i, x in enumerate(leaves):
            last, version = self._copied[i]
            if last is x and x._version == version:
                continue
            self._static[i].copy_(x)
            self._copied[i] = (x, x._version)

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
        self._fill(leaves)
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
        self._fill(leaves)
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
