"""Frame-to-frame visual odometry: one step, and a whole-sequence scan.

Counterpart of `jetracer_orbslam2_tpu/models/odometry.py`, whose
`odometry_step` is one dispatch a frame and whose `odometry_scan` keeps the
loop on the device.  Here `odometry_step` is the eager step, and
`odometry_scan` (with `ChunkedOdometry` on top) replays it as a CUDA graph:
captured once per configuration, as `jax.jit` compiles once, and replayed
once a frame (`utils/step_graph.StepGraph`, from the process-wide cache of
graphs: the first tracked frame of a configuration not yet captured runs
eagerly and warms up, the second captures; any later state of the
configuration replays from its first frame; on the CPU every frame runs
eagerly through the graph's buffers).  No step reads a value back to the
host: the rigid refit pair is one K5 launch on the card
(`fused_rigid.rigid_refit`), so a frame makes the host wait for nothing, and
results are fetched at the end of a scan or chunk.  RANSAC draws come from one
`torch.Generator` carried in the state, advanced once per tracked frame, in
a replay exactly as in an eager step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from jetracer_orbslam2_torch.config import FrontendConfig, TrackingConfig
from jetracer_orbslam2_torch.models import tracking
from jetracer_orbslam2_torch.models.frontend import Features, frontend_gray_depth
from jetracer_orbslam2_torch.utils.device import (
    HostStaging, as_f32, resolve_device)
from jetracer_orbslam2_torch.utils.precision import set_exact_f32
from jetracer_orbslam2_torch.utils.step_graph import StepGraph
from jetracer_orbslam2_torch.utils.timing import RECORDER

Tensor = torch.Tensor


class OdomState(NamedTuple):
    T_wc: Tensor        # (4, 4) current world<-camera pose
    velocity: Tensor    # (4, 4) T_prev_curr motion model
    prev: Features      # features of the previous frame
    frame_idx: Tensor   # () int32
    generator: torch.Generator  # RANSAC draws (the JAX state's base_key)
    graph: Optional[StepGraph] = None  # the scan's handle on its graph, carried


def make_generator(seed: int, device) -> torch.Generator:
    """One generator per run, on the run's device, seeded from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@torch.no_grad()
def init_state(
    gray0, depth0, intrinsics, fcfg: FrontendConfig,
    tcfg: TrackingConfig, seed: int = 0, device=None,
) -> OdomState:
    """State after the first frame.  Runs on `cuda:0` unless `device` says
    otherwise; inputs may be numpy arrays or tensors on any device."""
    dev = resolve_device(device)
    feats = frontend_gray_depth(
        gray0, depth0, intrinsics, fcfg,
        min_depth=tcfg.min_depth, max_depth=tcfg.max_depth, device=dev)
    return OdomState(
        T_wc=torch.eye(4, dtype=torch.float32, device=dev),
        velocity=torch.eye(4, dtype=torch.float32, device=dev),
        prev=feats,
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
        generator=make_generator(seed, dev),
    )


@torch.no_grad()
def odometry_step(
    state: OdomState, gray: Tensor, depth: Tensor, intrinsics: Tensor,
    fcfg: FrontendConfig, tcfg: TrackingConfig,
) -> tuple[OdomState, tracking.TrackResult]:
    """One odometry frame -> (state, TrackResult), on the state's device."""
    feats = frontend_gray_depth(
        gray, depth, intrinsics, fcfg,
        min_depth=tcfg.min_depth, max_depth=tcfg.max_depth,
        device=state.T_wc.device)
    res = tracking.track_rgbd(
        state.prev, feats, state.T_wc, state.velocity, intrinsics,
        state.generator, tcfg)
    new_state = OdomState(
        T_wc=res.T_wc,
        velocity=res.velocity,
        prev=feats,
        frame_idx=state.frame_idx + 1,
        generator=state.generator,
    )
    return new_state, res


def _graph_step(generator, prev: Features, gray, depth, T_wc, velocity,
                frame_idx, intrinsics, fcfg: FrontendConfig,
                tcfg: TrackingConfig):
    """The body the scan's graph captures: `odometry_step` on plain tensors,
    returning what the next frame and the scan's outputs need."""
    state = OdomState(T_wc=T_wc, velocity=velocity, prev=prev,
                      frame_idx=frame_idx, generator=generator)
    new, res = odometry_step(state, gray, depth, intrinsics, fcfg, tcfg)
    return new.prev, new.T_wc, new.velocity, new.frame_idx, res.tracked_ok


def step_graph(state: OdomState, frame_shape, fcfg: FrontendConfig,
               tcfg: TrackingConfig) -> StepGraph:
    """The state's handle when it was made for this configuration, frame
    shape and generator; else a new handle on the cached graph of the
    configuration (captured at the second call of the first run)."""
    return StepGraph.reuse(
        state.graph, lambda gen, *a: _graph_step(gen, *a, fcfg=fcfg, tcfg=tcfg),
        state.generator, (fcfg, tcfg, tuple(frame_shape), state.T_wc.device))


@torch.no_grad()
def odometry_scan(
    state: OdomState, grays, depths, intrinsics,
    fcfg: FrontendConfig, tcfg: TrackingConfig,
    live: Sequence[bool] | None = None,
) -> tuple[OdomState, Tensor, Tensor]:
    """Run odometry over a whole (N, H, W) sequence on the state's device:
    `odometry_step` once a frame through the state's `StepGraph` (a CUDA
    graph replay on the card).

    Returns (final state, (N,4,4) poses T_wc, (N,) tracked_ok), all device
    tensors; the caller fetches them once.  The final state carries the
    graph's handle, so a later scan from it (a chunk) counts on the same
    handle; a scan from another state of the configuration (or from the
    same state again, as `bench.py` times three) replays the same capture.
    live: (N,) HOST booleans, optional — False rows are inert padding (they
    leave the state untouched, draw nothing, and report the carried pose
    with tracked_ok False).
    """
    set_exact_f32()
    dev = state.T_wc.device
    grays = as_f32(grays, dev)
    depths = as_f32(depths, dev)
    intrinsics = as_f32(intrinsics, dev)
    n = grays.shape[0]
    if n == 0:
        return (state, torch.zeros((0, 4, 4), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    if live is not None:
        live = [bool(v) for v in np.asarray(live).tolist()]
    graph = step_graph(state, grays.shape[1:], fcfg, tcfg)
    not_ok = torch.zeros((), dtype=torch.bool, device=dev)
    poses, oks = [], []
    for i in range(n):
        if live is not None and not live[i]:
            poses.append(state.T_wc)
            oks.append(not_ok)
            continue
        state, ok = _replay(graph, state, grays[i], depths[i], intrinsics)
        poses.append(state.T_wc)
        oks.append(ok)
    return state._replace(graph=graph), torch.stack(poses), torch.stack(oks)


def _replay(graph: StepGraph, state: OdomState, gray: Tensor, depth: Tensor,
            intrinsics: Tensor) -> tuple[OdomState, Tensor]:
    """One frame through `graph` from `state`: (the state after it, carrying
    the graph; the frame's tracked_ok), device tensors."""
    prev, T_wc, velocity, frame_idx, ok = graph(
        state.prev, gray, depth, state.T_wc, state.velocity, state.frame_idx,
        intrinsics)
    return OdomState(T_wc=T_wc, velocity=velocity, prev=prev,
                     frame_idx=frame_idx, generator=state.generator,
                     graph=graph), ok


def _fetch(t: Tensor) -> np.ndarray:
    """`t` on the host: one wait, a span `entry.fetch`."""
    span = RECORDER.begin("entry.fetch")
    out = t.cpu().numpy()
    RECORDER.end(span, out.nbytes)
    return out


class ChunkedOdometry:
    """Constant-memory streaming odometry, the same computation as
    `odometry_scan` over the whole sequence: each frame is copied to the
    device and replayed through the state's `StepGraph` in the
    `process_frame` call that hands it in, so the device runs frame i while
    the host copies and enqueues frame i + 1.  Results equal the
    whole-sequence scan exactly (the same generator is advanced by the same
    frames in the same order, through the same graph call).

    Frames replay on a working state, which starts from `state` at each
    chunk's first frame; `flush`, at a chunk's end, commits it to `state`
    and fetches the chunk's results: the host waits twice a chunk, for its
    poses, then its tracked flags.  So `state` is the state at the last
    chunk committed, and device memory holds a chunk's poses and flags and
    the frames still queued.  The state carries the step's graph, so the
    whole run captures at most once (none when the configuration's graph is
    cached).

    On a CUDA device a host frame goes through pinned staging on a copy
    stream (`utils/device.HostStaging`), so its copy neither waits for the
    replays queued before it nor is queued behind them.  Counters:
    `frames_replayed_on_arrival`, and `staging_waits`, the times the host
    waited for a staging slot (0 when the copies keep up).

    Spans (`utils/timing.RECORDER`), a chunk's request id on each:
    `entry.frame` for a frame's part of `process_frame`, inside it
    `entry.copy` (the staging copy and the transfer's enqueue; the frame's
    bytes on the device as the value; not the bootstrap frame's) and the
    frame's `graph.replay`; `entry.chunk` for each `flush`, inside it one
    `entry.fetch` a wait (the bytes fetched)."""

    def __init__(self, intrinsics, fcfg: FrontendConfig,
                 tcfg: TrackingConfig, chunk_size: int = 32, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.intr = as_f32(intrinsics, self.device)
        self.fcfg, self.tcfg = fcfg, tcfg
        self.chunk = chunk_size
        self.seed = seed
        self.state: OdomState | None = None
        self.frames_replayed_on_arrival = 0
        self._staging = HostStaging(self.device)
        self._work: OdomState | None = None     # the chunk's working state
        self._pending_T: list = []               # the chunk's (4, 4) poses
        self._pending_ok: list = []              # and () tracked flags
        self._poses: list = [np.eye(4, dtype=np.float32)[None]]
        self._ok: list = [np.ones(1, bool)]
        self._request = RECORDER.new_request()

    @property
    def staging_waits(self) -> int:
        return self._staging.waits

    def process_frame(self, gray, depth) -> None:
        frame = RECORDER.begin("entry.frame", self._request)
        try:
            if self.state is None:
                gray, depth = self._staging.to_device(gray, depth)
                self.state = init_state(
                    gray, depth, self.intr, self.fcfg, self.tcfg,
                    seed=self.seed, device=self.device)
                return
            copy = RECORDER.begin("entry.copy")
            gray, depth = self._staging.to_device(gray, depth)
            RECORDER.end(copy, gray.nbytes + depth.nbytes)
            if not self._pending_T:             # the chunk's first frame
                set_exact_f32()
                self._work = self.state
            graph = step_graph(self._work, gray.shape, self.fcfg, self.tcfg)
            self._work, ok = _replay(graph, self._work, gray, depth, self.intr)
            self._pending_T.append(self._work.T_wc)
            self._pending_ok.append(ok)
            self.frames_replayed_on_arrival += 1
        finally:
            RECORDER.end(frame)
        if len(self._pending_T) >= self.chunk:
            self.flush()

    def flush(self) -> None:
        if not self._pending_T:
            return
        chunk = RECORDER.begin("entry.chunk", self._request)
        try:
            # a ragged tail is simply a shorter chunk: the graph holds one
            # frame's step, so a chunk's length is no shape of it
            poses = torch.stack(self._pending_T)
            ok = torch.stack(self._pending_ok)
            self._pending_T.clear()
            self._pending_ok.clear()
            self.state, self._work = self._work, None
            self._poses.append(_fetch(poses))
            self._ok.append(_fetch(ok))
        finally:
            RECORDER.end(chunk)
            self._request = RECORDER.new_request()

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """((N, 4, 4) poses, (N,) tracked) for all processed frames."""
        if self.state is None:
            return (np.zeros((0, 4, 4), np.float32), np.zeros(0, bool))
        return np.concatenate(self._poses), np.concatenate(self._ok)
