"""Whole-sequence SLAM over a frame stack that lives on the device.

Counterpart of `jetracer_orbslam2_tpu/models/slam_scan.py`.  There the whole
system is one compiled `lax.scan` with `lax.cond` picking the keyframe and
relocalization branches on the device: zero host round trips per frame.
Here `slam_scan` is a Python loop over the stack, and a frame is one replay
of a CUDA graph captured once per configuration, as `jax.jit` compiles
once (`utils/step_graph.FrameGraph`, from the process-wide cache of graphs:
a new state of a configuration already captured replays at its first
frame; the run's handle is carried in the state): the tracking half (front-end, `track_and_associate`, the
flags), then the relocalization branch and the keyframe branch (insert,
windowed BA, the loop retrieval and the top-n verifications as one batch,
and inside it the loop closure and the keyframe and map compaction), each
`lax.cond` a conditional node of the graph on a flag in device memory.  The
carried state lives in the graph's buffers; a branch writes its results
back into them, a branch not taken leaves them as they were, and a plain
frame copies no map.  Nothing is fetched until the caller fetches the
outputs: `ChunkedSlam` makes one fetch a chunk.  On the CPU the same frame
runs on the same buffers, each branch a host `if`.

The math, thresholds, gating, the draws (each frame draws its tracker's
samples and its branches' uniforms, whatever it goes on to do: the JAX
package's `fold_in(base_key, frame_idx)` rule) and the trajectory
convention (frames ride their reference keyframe's optimized pose) are
`models/slam.py`'s, so `slam_scan` and `Slam` seeded alike give the same
keyframes, closures and poses.  With a mesh the keyframe body's windowed BA
is `parallel/ba_sharded.sharded_local_ba`, its all-reduces and the gather of
the landmark blocks nodes of that body (K8, `ops/fused_allreduce.py`), as
the JAX package's `shard_map`'d BA runs inside its `lax.cond`: the mesh run
is the same one replay a frame.
`_step` is the same frame with host branches (the tracking half a graph
replay, the branches eager, with or without a mesh): the reference the
graphed frame is held against, and the route of a mesh on the card that K8
cannot serve (more than 8 ranks, ranks on several hosts: its collectives
are the group's own, which a conditional body cannot hold).  Which route a
scan takes follows from the mesh as it was set up (`scan_route`), never
from a failure; the final state names it (`ScanState.route`).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from jetracer_orbslam2_torch.config import SystemConfig
from jetracer_orbslam2_torch.models import imu as imu_mod
from jetracer_orbslam2_torch.models import slam as slam_mod
from jetracer_orbslam2_torch.models.backend import loop as loop_mod
from jetracer_orbslam2_torch.models.backend import map as map_mod
from jetracer_orbslam2_torch.models.backend.map import MapState
from jetracer_orbslam2_torch.models.frontend import Features, frontend_gray_depth
from jetracer_orbslam2_torch.models.odometry import make_generator
from jetracer_orbslam2_torch.models.stereo import frontend_stereo
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.utils.device import as_f32, resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32
from jetracer_orbslam2_torch.utils.step_graph import (
    Carry, FrameGraph, StepGraph, branch_values, cond, fetch)
from jetracer_orbslam2_torch.utils.timing import RECORDER

Tensor = torch.Tensor


class ScanState(NamedTuple):
    m: MapState
    prev: Features
    T_wc: Tensor            # (4, 4)
    velocity: Tensor        # (4, 4)
    frames_since_kf: Tensor  # () int32
    lost_streak: Tensor     # () int32
    frame_idx: Tensor       # () int32
    ref_slot: Tensor        # () int32 reference keyframe of the live frame
    num_loops: Tensor       # () int32
    num_relocs: Tensor      # () int32
    loop_prev_uid: Tensor   # () int32 last keyframe's winning loop candidate
    loop_consist: Tensor    # () int32 consecutive-detection streak
    generator: torch.Generator  # RANSAC draws (the JAX state's base_key)
    ba_edges_dropped: Tensor  # () int32 edges the sharded BA dropped
    graph: object = None    # the run's FrameGraph (or `_step`'s tracking
    #                         StepGraph), carried
    route: Optional[str] = None  # the last scan's: "frame_graph" or
    #                         "host_branch" (`scan_route`)


class ScanOutput(NamedTuple):
    """Per-frame emissions, stacked to length N."""

    ref_uid: Tensor         # (N,) int32 reference keyframe UID (frame_id:
    #                         stable across keyframe slot recycling)
    T_rel: Tensor           # (N, 4, 4) pose relative to ref keyframe AT EMIT
    T_w_emit: Tensor        # (N, 4, 4) live world pose at emit (fallback if
    #                         the ref keyframe aged out of the retired ring)
    tracked: Tensor         # (N,) bool
    is_kf: Tensor           # (N,) bool


def _features(gray, depth, intrinsics, cfg: SystemConfig, dev) -> Features:
    """Per-frame feature extraction.  RGB-D: (gray, depth) -> Features.
    Stereo (cfg.stereo set): the second channel IS the right image, and depth
    comes from the stereo front-end's epipolar matching."""
    t = cfg.tracking
    if cfg.stereo is not None:
        s = cfg.stereo
        return frontend_stereo(
            gray, depth, intrinsics, s.baseline, cfg.frontend,
            max_disparity=s.max_disparity, epipolar_tol=s.epipolar_tol,
            max_hamming=s.max_hamming,
            min_depth=t.min_depth, max_depth=t.max_depth,
            dist_r=s.dist_r, rect_l=s.rect_l, rect_r=s.rect_r,
            intrinsics_r=s.intrinsics_r, device=dev)
    return frontend_gray_depth(
        gray, depth, intrinsics, cfg.frontend,
        min_depth=t.min_depth, max_depth=t.max_depth, device=dev)


def _i32(value: int, dev) -> Tensor:
    # a fill on the device, not an upload: no host wait
    return torch.full((), value, dtype=torch.int32, device=dev)


@torch.no_grad()
def init_scan_state(
    gray0, depth0, intrinsics, cfg: SystemConfig, seed: int = 0, device=None,
) -> ScanState:
    """Bootstrap: frame 0 becomes the first keyframe (all depth keypoints
    spawn landmarks), exactly as `models/slam.Slam`'s first frame.  device:
    None is cuda:0 (raises without a CUDA device), "cpu" on request."""
    dev = resolve_device(device)
    set_exact_f32()
    feats = _features(gray0, depth0, as_f32(intrinsics, dev), cfg, dev)
    m = map_mod.init_map(cfg.map, cfg.frontend.max_keypoints,
                         cfg.frontend.num_descriptor_words, device=dev)
    k = feats.xy.shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    m, slot = map_mod.insert_keyframe(
        m, feats, eye, _i32(0, dev), feats.has_point,
        torch.zeros(k, dtype=torch.int32, device=dev),
        torch.zeros(k, dtype=torch.bool, device=dev), device=dev)
    return ScanState(
        m=m, prev=feats, T_wc=eye, velocity=eye,
        frames_since_kf=_i32(0, dev), lost_streak=_i32(0, dev),
        frame_idx=_i32(1, dev), ref_slot=slot.to(torch.int32),
        num_loops=_i32(0, dev), num_relocs=_i32(0, dev),
        loop_prev_uid=_i32(loop_mod.NO_CANDIDATE_UID, dev),
        loop_consist=_i32(0, dev),
        generator=make_generator(seed, dev), ba_edges_dropped=_i32(0, dev),
    )


# the fields of ScanState a frame reads and rewrites
_CARRIED = ("m", "prev", "T_wc", "velocity", "frames_since_kf", "lost_streak",
            "frame_idx", "ref_slot", "num_loops", "num_relocs",
            "loop_prev_uid", "loop_consist", "ba_edges_dropped")



def _skip(state) -> tuple:
    """The row a padding frame emits: the carried pose against the carried
    reference keyframe, untracked, no keyframe; the state is untouched."""
    dev = state.T_wc.device
    ref_pose = loop_mod._row(state.m.kf_pose, state.ref_slot)
    no = slam_mod.step_constants(dev)["false"]
    return (loop_mod._row(state.m.kf_frame_id, state.ref_slot),
            geo.pose_inverse(ref_pose) @ state.T_wc, state.T_wc.clone(), no,
            no)


def _frame(S: Carry, track, frame, imu, intrinsics, cfg: SystemConfig,
           mesh=None) -> tuple:
    """One SLAM frame on the carried state S: `track` (a tracking graph, or
    `slam.tracking_step` inside the frame graph) on `frame` (gray, depth),
    then the relocalization and keyframe branches.  imu: (delta_w (3,),
    ok () bool) on the device.  mesh: the keyframe body's windowed BA runs
    landmark-sharded over it, and its dropped edges add to the carried
    count.  Returns the output row (need_kf as a () bool) and the keyframe
    decision as the branches read it."""
    dev = S.T_wc.device
    step = track(S.prev, frame, S.m, S.T_wc, S.velocity, *imu,
                 S.frames_since_kf, S.lost_streak, intrinsics)
    feats, report = step.feats, step.report
    frame_idx = S.frame_idx
    try_reloc, need_kf = branch_values(step.flags[2], step.flags[1])
    S.set(T_wc=report.T_wc, velocity=step.velocity,
          lost_streak=step.lost_streak, frames_since_kf=step.since_kf)

    def relocalization():
        ok, T_new = slam_mod.relocalize(S.m, feats, None, cfg, dev,
                                        uniforms=step.u_reloc)
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        S.set(T_wc=torch.where(ok, T_new, S.T_wc),
              velocity=torch.where(ok, eye, S.velocity),
              lost_streak=torch.where(ok, 0, S.lost_streak).to(torch.int32),
              num_relocs=(S.num_relocs + ok.to(torch.int32)).to(torch.int32))

    def keyframe():
        up = slam_mod.keyframe_update(
            S.m, feats, S.T_wc, frame_idx, step.lm_idx, step.lm_ok,
            intrinsics, cfg, None, S.loop_prev_uid, S.loop_consist,
            mesh=mesh, device=dev, uniforms=step.u_loop)
        S.set(m=up.m, T_wc=up.T_wc, ref_slot=up.slot.to(torch.int32),
              loop_prev_uid=up.loop_prev_uid, loop_consist=up.loop_consist,
              num_loops=(S.num_loops + up.looped).to(torch.int32),
              frames_since_kf=torch.ones_like(S.frames_since_kf))
        if mesh is not None:
            S.set(ba_edges_dropped=(S.ba_edges_dropped
                                    + up.ba_dropped).to(torch.int32))

    cond(try_reloc, relocalization, name="relocalization")
    cond(need_kf, keyframe, name="keyframe")
    ref_pose = loop_mod._row(S.m.kf_pose, S.ref_slot)
    row = (loop_mod._row(S.m.kf_frame_id, S.ref_slot),
           geo.pose_inverse(ref_pose) @ S.T_wc, S.T_wc.clone(),
           report.tracked_ok, report.need_kf)
    S.set(prev=feats, frame_idx=(frame_idx + 1).to(torch.int32))
    return row, need_kf


def frame_extract(cfg: SystemConfig, dev):
    """`_features` as the `extract` of `slam.tracking_step`."""
    return lambda first, second, intr: _features(first, second, intr, cfg, dev)


def tracking_graph(state: ScanState, cfg: SystemConfig) -> StepGraph:
    """The state's handle on the tracking graph when it was made for this
    configuration and generator; else a new handle on the cached graph of
    the configuration (captured at the second call of the first run)."""
    dev = state.T_wc.device
    return slam_mod.tracking_graph(state.generator, cfg, frame_extract(cfg, dev),
                                   key=(cfg, dev, "frame"), carried=state.graph)


def scan_route(mesh=None) -> str:
    """The route of `slam_scan` with `mesh`: "frame_graph" (one replay of
    the frame graph a frame) without a mesh, with a CPU mesh and with a
    mesh on the card whose collectives are K8; "host_branch" (`_step` a
    frame, 1 host wait on a plain frame and 2 on a keyframe frame) with a
    mesh on the card that K8 cannot serve, whose collectives, the group's
    own, a conditional body cannot hold.  It follows from the record the
    mesh made as it was set up (`Mesh.k8_unservable`), as NCCL's choice of
    an algorithm follows from the group's shape: nothing falls back on a
    failure, and a closed mesh raises."""
    if mesh is None or mesh.capturable:
        return "frame_graph"
    if mesh.k8_unservable is None:
        mesh.check_capturable()          # closed: raises
    return "host_branch"


def frame_graph(state: ScanState, cfg: SystemConfig, mesh=None) -> FrameGraph:
    """The state's handle on the frame graph when it was made for this
    configuration, mesh (None: none) and generator; else a new handle on the
    cached graph of the configuration and mesh (warmed up and captured at
    the first call of the first run; `Mesh.close` drops a mesh's graphs).
    Raises for a mesh whose collectives a conditional body cannot hold
    (`Mesh.check_capturable`); `slam_scan` runs such a mesh's frames
    through `_step` instead (`scan_route`)."""
    dev = state.T_wc.device
    if mesh is not None:
        mesh.check_capturable()
    extract = frame_extract(cfg, dev)

    def fn(generator, carried, gray, depth, imu_delta_w, imu_ok, intrinsics):
        def track(*a):
            return slam_mod.tracking_step(generator, *a, cfg=cfg,
                                          extract=extract)

        S = Carry(dict(zip(_CARRIED, carried)), in_place=True)
        row, _ = _frame(S, track, (gray, depth), (imu_delta_w, imu_ok),
                        intrinsics, cfg, mesh)
        return row

    return FrameGraph.reuse(state.graph, fn, state.generator,
                            key=(cfg, dev, "frame", mesh))


def _imu_inputs(imu, dev) -> tuple:
    imu_delta_w, imu_ok = imu
    const = slam_mod.step_constants(dev)
    if imu_ok:
        return imu_delta_w, const["true"]
    return const["no_imu"], const["false"]


def _step(state: ScanState, gray, depth, imu, intrinsics,
          cfg: SystemConfig, mesh=None, graph: Optional[StepGraph] = None,
          plain_collectives: bool = False) -> tuple[ScanState, tuple]:
    """One SLAM frame with host branches: the tracking half through `graph`
    (`tracking_graph(state, cfg)` when None), then the branches eagerly, on
    the frame's flags fetched together (one wait), and at a keyframe on its
    verdict and counters (one more).  imu: (delta_w (3,) device tensor or
    None, ok host bool).  Returns the new state and the frame's output row,
    whose last entry (`is_kf`) is a host bool.  mesh: see `slam_scan`; the
    host-branch reference of the mesh run too, whose collectives are the
    group's own all-reduce (K8's plain version, `Mesh.reference`) when
    `plain_collectives`."""
    if mesh is not None and plain_collectives:
        mesh = mesh.reference()
    dev = state.T_wc.device
    if graph is None:
        graph = tracking_graph(state, cfg)
    S = Carry({f: getattr(state, f) for f in _CARRIED}, in_place=False)
    row, need_kf = _frame(S, graph, (gray, depth), _imu_inputs(imu, dev),
                          intrinsics, cfg, mesh)
    new_state = ScanState(**S.fields, generator=state.generator, graph=graph)
    return new_state, row[:4] + (need_kf == 1,)


def _host_bools(flags, n: int) -> list:
    if flags is None:
        return [True] * n
    if isinstance(flags, Tensor):
        flags = flags.cpu().numpy()
    return [bool(v) for v in np.asarray(flags).tolist()]


@torch.no_grad()
def slam_scan(
    state: ScanState, grays, depths, intrinsics, cfg: SystemConfig,
    imu_delta_w=None,            # (N, 3) per-frame gyro rotation
    imu_valid=None,              # (N,) host bools
    mesh=None,
    live=None,                   # (N,) host bools; False = padding
) -> tuple[ScanState, ScanOutput]:
    """Run the FULL SLAM system over an (N, H, W) frame stack on the state's
    device.  `depths` holds the depth maps, or the right images when
    `cfg.stereo` is set.

    imu_valid and live are read on the host (a tensor is fetched once, before
    the loop).  Frames with live=False are inert padding: no tracking, no
    state change, no draw; their output row is the carried pose, untracked.
    mesh: a `parallel.mesh.Mesh` on the state's device; every windowed BA
    inside the scan then runs landmark-sharded over it
    (`parallel.ba_sharded.sharded_local_ba`) in the frame graph's keyframe
    body, and every rank runs the scan in lockstep (each replays its own
    graph; the branch flags come from state that is the same on every rank).
    A mesh on the card that K8 cannot serve runs every frame through the
    host-branch step `_step` with the group's collectives instead
    (`scan_route`); the final state's `route` names the route taken.

    Returns (final state, per-frame ScanOutput on the device).  Use
    `compose_trajectory` to turn the output into world poses that reflect
    every BA/loop correction.  The state's generator is advanced: a second
    scan from the same state draws other samples.
    """
    set_exact_f32()
    dev = state.T_wc.device
    if mesh is not None:
        slam_mod.mesh_device(mesh, dev, cfg)
    grays, depths = as_f32(grays, dev), as_f32(depths, dev)
    intrinsics = as_f32(intrinsics, dev)
    n = grays.shape[0]
    if n == 0:
        f32 = dict(dtype=torch.float32, device=dev)
        return state, ScanOutput(
            ref_uid=torch.zeros(0, dtype=torch.int32, device=dev),
            T_rel=torch.zeros((0, 4, 4), **f32),
            T_w_emit=torch.zeros((0, 4, 4), **f32),
            tracked=torch.zeros(0, dtype=torch.bool, device=dev),
            is_kf=torch.zeros(0, dtype=torch.bool, device=dev))
    live = _host_bools(live, n)
    imu_ok = _host_bools(imu_valid, n) if imu_delta_w is not None else [False] * n
    if imu_delta_w is not None:
        imu_delta_w = as_f32(imu_delta_w, dev)
    imu = [(imu_delta_w[i] if imu_ok[i] else None, imu_ok[i]) for i in range(n)]
    frames = (_host_branch_frames if scan_route(mesh) == "host_branch"
              else _graph_frames)
    state, rows = frames(state, grays, depths, imu, intrinsics, cfg, mesh,
                         live)
    ref_uid, T_rel, T_w_emit, tracked, is_kf = zip(*rows)
    return state, ScanOutput(
        ref_uid=torch.stack(ref_uid), T_rel=torch.stack(T_rel),
        T_w_emit=torch.stack(T_w_emit), tracked=torch.stack(tracked),
        is_kf=torch.stack(is_kf))


def _graph_frames(state, grays, depths, imu, intrinsics, cfg, mesh,
                  live) -> tuple:
    """`slam_scan`'s frames as replays of the frame graph: (the final state,
    the frames' output rows)."""
    dev = state.T_wc.device
    rows = []
    graph = frame_graph(state, cfg, mesh)
    carried = tuple(getattr(state, f) for f in _CARRIED)
    current = state
    for i, frame_live in enumerate(live):
        if not frame_live:
            rows.append(_skip(current))
            continue
        rows.append(graph(carried, grays[i], depths[i],
                          *_imu_inputs(imu[i], dev), intrinsics))
        carried = tuple(graph.carry())
        current = Carry(dict(zip(_CARRIED, carried)), in_place=False)
    if any(live):
        carried = graph.export()
    return ScanState(**dict(zip(_CARRIED, carried)), generator=state.generator,
                     graph=graph, route="frame_graph"), rows


def _host_branch_frames(state, grays, depths, imu, intrinsics, cfg, mesh,
                        live) -> tuple:
    """`slam_scan`'s frames through the host-branch step `_step` with the
    mesh's collectives (the group's own): (the final state, the frames'
    output rows, each keyframe flag on the device)."""
    const = slam_mod.step_constants(state.T_wc.device)
    rows = []
    for i, frame_live in enumerate(live):
        if not frame_live:
            rows.append(_skip(state))
            continue
        state, row = _step(state, grays[i], depths[i], imu[i], intrinsics,
                           cfg, mesh)
        rows.append(row[:4] + (const["true" if row[4] else "false"],))
    return state._replace(route="host_branch"), rows


class ChunkedSlam:
    """Online SLAM in micro-batches: frames are processed in fixed-size
    chunks through `slam_scan`, and the host waits on the device ONCE a
    chunk: the chunk's per-frame outputs (and the branches its frames took,
    for the launch counters) come back in one fetch.  With a mesh on the
    card that K8 cannot serve the chunk's frames take the host-branch route
    (`route`), whose branches wait on the host as well.  The trade is decision
    latency: keyframe, loop and relocalization actions land within the
    chunk, and the host sees reports `chunk_size` frames late.

    Spans (`utils/timing.RECORDER`), a chunk's request id on each:
    `entry.frame`, `entry.copy`, `entry.chunk`, `entry.stack` and
    `entry.fetch` as in `odometry.ChunkedOdometry`, here one fetch a chunk;
    on the frame-graph route, for each body the chunk's replays took, one
    record `graph.body.<name>` whose count is those replays and whose value
    is their device ns (on the host-branch route and the CPU, each body
    taken is a span of its own, `step_graph.cond`)."""

    def __init__(self, cfg: SystemConfig, intrinsics, chunk_size: int = 8,
                 seed: int = 0, mesh=None, device=None):
        """device: None is cuda:0, "cpu" on request; with a mesh, the mesh's
        (see `slam.Slam`)."""
        set_exact_f32()
        self.device = slam_mod.mesh_device(mesh, device, cfg)
        self.mesh = mesh
        self.route = scan_route(mesh)
        self.cfg = cfg
        self.intr = as_f32(intrinsics, self.device)
        self.chunk = chunk_size
        self.seed = seed
        self.state: Optional[ScanState] = None
        self._outs: list[ScanOutput] = []     # numpy fields, one per chunk
        self._pending_g: list = []
        self._pending_d: list = []
        self._pending_iw: list = []      # per-frame gyro deltas (3,), host
        self._pending_iv: list = []      # per-frame IMU validity, host
        self.imu_state = imu_mod.init_state()
        self._request = RECORDER.new_request()

    def process_frame(self, gray, depth, imu_packet=None) -> Optional[ScanOutput]:
        """Feed one frame (`depth` is the right image when `cfg.stereo` is
        set); returns the chunk's ScanOutput (numpy fields) every
        `chunk_size` frames, None otherwise.

        imu_packet: optional fixed-size per-frame IMU packet (gyro, gyro_ts,
        accel, gyro_valid, accel_valid).  The gyro integral between frames
        feeds `slam_scan`'s imu_delta_w motion prior; the packet is folded on
        the host and reaches the device with the chunk."""
        frame = RECORDER.begin("entry.frame", self._request)
        try:
            delta_w, imu_ok = np.zeros(3, np.float32), False
            if imu_packet is not None:
                self.imu_state, delta_w = imu_mod.process_packet_with_delta(
                    self.imu_state, *imu_packet)
                imu_ok = bool(np.any(np.asarray(imu_packet[3])))
            if self.state is None:
                self.state = init_scan_state(
                    gray, depth, self.intr, self.cfg, seed=self.seed,
                    device=self.device)
                return None
            # no local holds the frame: the chunk's stack must be its only
            # copy once the pending lists are cleared
            copy = RECORDER.begin("entry.copy")
            self._pending_g.append(as_f32(gray, self.device))
            self._pending_d.append(as_f32(depth, self.device))
            RECORDER.end(copy, self._pending_g[-1].nbytes
                         + self._pending_d[-1].nbytes)
            self._pending_iw.append(delta_w)
            self._pending_iv.append(imu_ok)
        finally:
            RECORDER.end(frame)
        if len(self._pending_g) < self.chunk:
            return None
        return self.flush()

    def flush(self) -> Optional[ScanOutput]:
        """Run the buffered frames through the scan.  A ragged tail is simply
        a shorter chunk: the tracking graph holds one frame's step, so a
        chunk's length is no shape of it."""
        if not self._pending_g:
            return None
        chunk = RECORDER.begin("entry.chunk", self._request)
        try:
            stack = RECORDER.begin("entry.stack")
            g, d = torch.stack(self._pending_g), torch.stack(self._pending_d)
            RECORDER.end(stack, g.nbytes + d.nbytes)
            iw = (slam_mod.imu_upload(np.stack(self._pending_iw), self.device)
                  if any(self._pending_iv) else None)
            iv = list(self._pending_iv)
            for pending in (self._pending_g, self._pending_d,
                            self._pending_iw, self._pending_iv):
                pending.clear()
            self.state, out = slam_scan(
                self.state, g, d, self.intr, self.cfg,
                imu_delta_w=iw, imu_valid=iv, mesh=self.mesh)
            graph = self.state.graph
            counts = (graph.branch_counts() if self.route == "frame_graph"
                      else None)
            span = RECORDER.begin("entry.fetch")
            host = fetch(*out, *(() if counts is None else (counts,)))
            RECORDER.end(span, sum(h.nbytes for h in host))
            if counts is not None:
                graph.settle(host[-1])
                _record_bodies(graph.body_names, host[-1])
            out = ScanOutput(*host[:len(ScanOutput._fields)])
            self._outs.append(out)
            return out
        finally:
            RECORDER.end(chunk)
            self._request = RECORDER.new_request()

    def tracked(self) -> np.ndarray:
        """(N,) tracked flags of all processed frames (the bootstrap frame
        counts as tracked)."""
        first = np.ones(0 if self.state is None else 1, bool)
        return np.concatenate([first] + [o.tracked for o in self._outs])

    def result(self) -> np.ndarray:
        """(N, 4, 4) world poses for all processed frames (frame 0 = the
        bootstrap keyframe's optimized pose)."""
        if self.state is None:
            return np.zeros((0, 4, 4), np.float32)
        kf0 = self.state.m.kf_pose[:1].cpu().numpy()
        if not self._outs:
            return kf0
        merged = ScanOutput(*[
            np.concatenate([getattr(o, f) for o in self._outs])
            for f in ScanOutput._fields])
        return np.concatenate([kf0, compose_trajectory(self.state, merged)])


def _record_bodies(names: list, counts: np.ndarray) -> None:
    """One record `graph.body.<name>` for each body a chunk's replays took,
    inside the chunk's span, at the moment the counts reached the host (no
    duration of its own): the replays as its count, their device ns
    (`FrameGraph.branch_counts`) as its value."""
    now = time.perf_counter_ns()
    for name, taken, ns in zip(names, counts[0].tolist(), counts[1].tolist()):
        if taken:
            RECORDER.record("graph.body." + name, now, now, value=int(ns),
                            count=int(taken))


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def compose_trajectory(final: ScanState, out: ScanOutput) -> np.ndarray:
    """(N, 4, 4) world poses: each frame rides its reference keyframe's
    FINAL optimized pose, so later BA/loop corrections apply retroactively
    (the convention of `models/slam.Slam.result`).  Reference keyframes are
    addressed by UID: keyframes culled by compact_keyframes resolve through
    the retired-anchor ring; on ring overflow the frame falls back to its
    world pose at emission time."""
    table = map_mod.resolve_kf_poses(final.m)
    ref, rel, emit = _numpy(out.ref_uid), _numpy(out.T_rel), _numpy(out.T_w_emit)
    if ref.shape[0] == 0:
        return np.zeros((0, 4, 4), np.float32)
    return np.stack([
        table[int(u)] @ r if int(u) in table else e
        for u, r, e in zip(ref, rel, emit)
    ])
