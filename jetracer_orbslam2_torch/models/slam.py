"""Full SLAM system: tracking + keyframe map + local BA + loop closure.

Counterpart of `jetracer_orbslam2_tpu/models/slam.py`.

  * Every per-frame computation is one of a handful of fixed-shape functions
    (track step, landmark association, keyframe insert, windowed BA, loop
    retrieve/verify/close).
  * The tracking half of a frame (`tracking_step`: the front-end when the
    frame is an image pair, `track_and_associate`, the scheduler's flags) is
    captured once into a CUDA graph and replayed once a frame
    (`utils/step_graph.StepGraph`).
  * The relocalization and keyframe branches (`relocalize`,
    `keyframe_update`, and inside it the loop closure and `compact_if_full`)
    branch through `utils/step_graph.cond`: inside `models/slam_scan.py`'s
    frame graph each is a conditional node of the graph, which waits for
    nothing; called eagerly, as `Slam` calls them, each branch is a host
    `if` on values fetched together (`step_graph.branch_values`).
  * `Slam`, the host loop, is a thin scheduler: it reads back one packed
    tensor per frame and, at a keyframe, the loop verdict and the capacity
    counters in one more fetch, and picks which functions to run.  On the
    card the rigid refits are the K5 kernel (`fused_rigid`), which waits for
    nothing (its SVD route runs on the CPU only).
  * Local BA runs over a fixed-size keyframe window against the full
    fixed-capacity landmark table with masked observations.

RANSAC draws come from one `torch.Generator` per system and never depend on
which branches ran, the JAX package's `fold_in(base_key, frame_idx)` rule:
every frame's tracking step draws the tracker's samples, then one block of
uniforms for relocalization and one for the loop verification, whatever the
frame goes on to do.  The branches turn their block into samples
(`tracking.samples_from_uniforms`), so `models/slam_scan.py` (whose graph
replays advance the generator by the whole frame's draws) and `Slam` agree
when seeded alike.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from jetracer_orbslam2_torch.config import SystemConfig
from jetracer_orbslam2_torch.models import imu as imu_mod
from jetracer_orbslam2_torch.models import tracking
from jetracer_orbslam2_torch.models.backend import loop as loop_mod
from jetracer_orbslam2_torch.models.backend import map as map_mod
from jetracer_orbslam2_torch.models.backend.ba import BAProblem, bundle_adjust
from jetracer_orbslam2_torch.models.backend.map import (
    MapState, _features_to, _map_to)
from jetracer_orbslam2_torch.models.frontend import Features, frontend_gray_depth
from jetracer_orbslam2_torch.models.odometry import make_generator
from jetracer_orbslam2_torch.ops import fused_rigid
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.utils.device import as_f32, resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32
from jetracer_orbslam2_torch.utils.step_graph import (
    Carry, StepGraph, branch_values, cond, in_graph)
from jetracer_orbslam2_torch.utils.ties import first_argmax

Tensor = torch.Tensor

# Which route `local_ba` gives `bundle_adjust` when the caller does not say:
# None lets `bundle_adjust` choose (the fused kernels on a CUDA device within
# their pose cap, the dense route on the CPU), False pins the dense route.
# The JAX package pins its dense route here for a reason that belongs to its
# compiler; on the card the choice follows the measurement `chip_smoke.py`
# prints for both routes at the map's full size (PERF.md has the numbers).
LOCAL_BA_FUSED: Optional[bool] = None


def window_problem(m: MapState, window_size: int) -> tuple[BAProblem, Tensor]:
    """The BA problem of the `window_size` newest keyframes, and their slots.

    Fixed shapes: P = window_size poses, all L landmarks (masked), all E
    observations (invalid outside the window).  The oldest window pose is
    gauge-fixed (plus everything outside the window, implicitly, because
    only window poses enter the problem).
    """
    dev = m.kf_pose.device
    Kf = m.kf_valid.shape[0]
    W = window_size
    newest = m.num_kf.to(torch.int64) - 1
    window = (newest - W + 1 + torch.arange(W, device=dev)).clamp(0, Kf - 1)

    # window-local index for each observation (or invalid)
    eq = m.obs_kf[:, None] == window[None, :]            # (E, W)
    in_win = torch.any(eq, dim=1) & m.obs_valid
    _, local_kf = first_argmax(eq.to(torch.int32), 1)

    # with fewer than W keyframes, slots repeat: fix all duplicates of slot 0
    # (entry 0 itself, the oldest window pose, is always among them)
    fixed = window == window[0]
    prob = BAProblem(
        poses=m.kf_pose[window],
        points=m.lm_pos,
        obs_kf=local_kf.to(torch.int32),
        obs_lm=m.obs_lm,
        obs_uv=m.obs_uv,
        obs_z=m.obs_z,
        obs_z_valid=m.obs_z > 0.0,
        obs_valid=in_win,
        fixed=fixed,
    )
    return prob, window


def local_ba(
    m: MapState,
    intrinsics: Tensor,
    window_size: int,
    cfg: SystemConfig,
    fused: Optional[bool] = LOCAL_BA_FUSED,
    device=None,
) -> MapState:
    """Windowed bundle adjustment over the `window_size` newest keyframes
    (the problem `window_problem` builds).  `fused` is `bundle_adjust`'s;
    device: None is cuda:0 (raises without a CUDA device), "cpu" on request.
    """
    dev = resolve_device(device)
    set_exact_f32()
    m = _map_to(m, dev)
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32).to(dev)
    prob, window = window_problem(m, window_size)
    new_poses, new_points, _ = bundle_adjust(
        prob, intrinsics, cfg.ba, fused=fused, device=dev)
    # repeated window slots are all gauge-fixed and carry the same pose, so
    # the order of their writes does not matter
    kf_pose = m.kf_pose.index_copy(0, window, new_poses)
    lm_pos = torch.where(m.lm_valid[:, None], new_points, m.lm_pos)
    return m._replace(kf_pose=kf_pose, lm_pos=lm_pos)


class FrameReport(NamedTuple):
    """Small per-frame summary, and the scheduler's input.

    `packed` carries every scalar the host scheduler needs as ONE (20,) f32
    tensor, [tracked, need_kf, num_matches, num_assoc, T_wc.ravel()], so the
    per-frame decision costs exactly one device->host fetch."""

    tracked_ok: Tensor    # () bool
    num_matches: Tensor   # () int32 frame-to-frame matches
    num_assoc: Tensor     # () int32 map landmark associations
    need_kf: Tensor       # () bool keyframe decision
    T_wc: Tensor          # (4, 4)
    packed: Tensor        # (20,) f32 single-fetch host payload


@torch.no_grad()
def track_and_associate(
    prev: Features,
    curr: Features,
    m: MapState,
    T_w_prev: Tensor,
    velocity: Tensor,
    imu_delta_w,
    imu_ok: bool,
    frames_since_kf,
    intrinsics: Tensor,
    generator: Optional[torch.Generator],
    cfg: SystemConfig,
    sample_idx: Optional[Tensor] = None,
    device=None,
) -> tuple[tracking.TrackResult, Tensor, Tensor, FrameReport]:
    """One SLAM tracking step: odometry + map association + KF decision.

    imu_delta_w (3,) / imu_ok (a host bool, or a () bool tensor inside a
    captured step): gyro-integrated body rotation between the previous and
    the current frame.  When present it REPLACES the rotation part of the
    constant-velocity prior (during erratic motion or a camera blackout the
    gyro knows the turn the motion model cannot); the translation prior
    stays constant-velocity.  Assumes identity camera-IMU rotation.
    frames_since_kf: a host int or a 0-dim tensor.
    sample_idx: optional (ransac_iters, 3) RANSAC samples for the tracker.

    Returns (track result, lm_idx (K,), lm_ok (K,), report).
    """
    dev = resolve_device(device)
    set_exact_f32()
    prev, curr, m = _features_to(prev, dev), _features_to(curr, dev), _map_to(m, dev)
    T_w_prev, velocity = as_f32(T_w_prev, dev), as_f32(velocity, dev)
    intrinsics = as_f32(intrinsics, dev)
    if isinstance(imu_ok, Tensor):
        # a device flag: both priors are computed and the flag picks one
        imu_velocity = geo.pose_from_rt(
            geo.so3_exp(as_f32(imu_delta_w, dev)), velocity[:3, 3])
        velocity = torch.where(imu_ok, imu_velocity, velocity)
    elif imu_ok:
        velocity = geo.pose_from_rt(
            geo.so3_exp(as_f32(imu_delta_w, dev)), velocity[:3, 3])
    res = tracking.track_rgbd(
        prev, curr, T_w_prev, velocity, intrinsics, generator, cfg.tracking,
        sample_idx=sample_idx)

    # associate current keypoints to map landmarks at the tracked pose
    lm_idx, lm_ok = map_mod.associate_landmarks(
        m, curr, res.T_wc, intrinsics,
        max_hamming=float(cfg.tracking.match_max_hamming),
        window=cfg.tracking.match_window, device=dev)
    has_map = m.num_kf > 0
    lm_ok = lm_ok & has_map
    n_assoc = torch.sum(lm_ok).to(torch.int32)

    # pose refinement against the map: 3D-3D between current camera points
    # and associated landmark world positions (drift containment).  One
    # trimmed re-fit makes the plain Kabsch robust to association outliers
    # without a full RANSAC (the associations are already descriptor- and
    # window-gated): fit, drop residuals of 2 x the RANSAC gate, fit again,
    # one K5 launch on the card.
    pts_w = m.lm_pos[lm_idx.long()]                     # (K, 3) world
    w = (lm_ok & curr.has_point).to(torch.float32)
    T_ref, w_trim, n_trim = fused_rigid.rigid_refit(    # world <- camera
        curr.points, pts_w, w, w, 2.0 * cfg.tracking.ransac_inlier_thresh)
    enough = n_trim >= cfg.tracking.min_inliers
    # motion-only reprojection polish against the MAP: landmark positions
    # are BA-refined, and pixel measurements are unbiased where 3D depth
    # noise grows as z^2, so the final pose minimizes reprojection of the
    # associated landmarks onto the current keypoints
    if cfg.tracking.map_polish_iters > 0:
        z_meas = torch.where(curr.has_point, curr.points[:, 2],
                             torch.zeros_like(curr.points[:, 2]))
        T_cw = tracking.refine_pose_reprojection(
            geo.pose_inverse(T_ref), pts_w, curr.xy, z_meas, w_trim,
            intrinsics, iters=cfg.tracking.map_polish_iters)
        T_map = geo.pose_inverse(T_cw)
    else:
        T_map = T_ref
    T_wc = torch.where(enough & res.tracked_ok, T_map, res.T_wc)
    res = res._replace(T_wc=T_wc)

    n_pts = torch.sum(curr.has_point).to(torch.float32)
    ratio = n_assoc.to(torch.float32) / n_pts.clamp_min(1.0)
    gap_ok = frames_since_kf >= cfg.map.kf_min_gap
    gap_max = frames_since_kf >= cfg.map.kf_max_gap
    need_kf = (
        (~has_map)
        | (((ratio < cfg.map.kf_min_inlier_ratio) | gap_max) & gap_ok)
    ) & res.tracked_ok | (~has_map)
    packed = torch.cat([
        torch.stack([res.tracked_ok, need_kf]).to(torch.float32),
        torch.stack([res.num_matches, n_assoc]).to(torch.float32),
        T_wc.reshape(16),
    ])
    report = FrameReport(
        tracked_ok=res.tracked_ok,
        num_matches=res.num_matches,
        num_assoc=n_assoc,
        need_kf=need_kf,
        T_wc=T_wc,
        packed=packed,
    )
    return res, lm_idx, lm_ok, report


class TrackingStep(NamedTuple):
    """What `tracking_step` returns: the scheduler's inputs for the frame."""

    feats: Optional[Features]  # the frame's features (None when given)
    velocity: Tensor      # (4, 4) T_prev_curr used as the next prior
    lm_idx: Tensor        # (K,) int32 map landmark of each keypoint
    lm_ok: Tensor         # (K,) bool association valid
    report: FrameReport
    since_kf: Tensor      # () int32 frames_since_kf + 1 (no keyframe here)
    lost_streak: Tensor   # () int32 after this frame
    flags: Tensor         # (3,) bool [tracked, need_kf, try_reloc]
    u_reloc: Tensor       # (512, 3) the relocalization's uniforms
    u_loop: Tensor        # (topn, 512, 3) the loop verification's uniforms


def tracking_step(generator, prev: Features, frame, m: MapState, T_w_prev,
                  velocity, imu_delta_w, imu_ok, frames_since_kf, lost_streak,
                  intrinsics, *, cfg: SystemConfig,
                  extract=None) -> TrackingStep:
    """The tracking half of a SLAM frame, the body a `StepGraph` captures:
    `frame` is the frame's Features, or with `extract` an image pair
    (first, second) that `extract(first, second, intrinsics)` turns into
    them; then `track_and_associate`, the flags the branches take, and the
    frame's fixed block of uniforms for those branches (drawn whatever they
    do, so no later draw depends on them).  imu_ok, frames_since_kf and
    lost_streak are () device tensors."""
    dev = T_w_prev.device
    feats = frame if extract is None else extract(*frame, intrinsics)
    res, lm_idx, lm_ok, report = track_and_associate(
        prev, feats, m, T_w_prev, velocity, imu_delta_w, imu_ok,
        frames_since_kf, intrinsics, generator, cfg, device=dev)
    tracked = report.tracked_ok
    lost = torch.where(tracked, 0, lost_streak + 1).to(torch.int32)
    try_reloc = (~tracked) & (lost >= cfg.reloc.after_frames)
    iters = loop_mod.VERIFY_RANSAC_ITERS
    u_reloc = torch.rand((iters, 3), generator=generator, device=dev)
    u_loop = torch.rand((cfg.loop.topn, iters, 3), generator=generator,
                        device=dev)
    return TrackingStep(
        feats=None if extract is None else feats, velocity=res.velocity,
        lm_idx=lm_idx, lm_ok=lm_ok, report=report,
        since_kf=(frames_since_kf + 1).to(torch.int32), lost_streak=lost,
        flags=torch.stack([tracked, report.need_kf, try_reloc]),
        u_reloc=u_reloc, u_loop=u_loop)


def tracking_graph(generator: torch.Generator, cfg: SystemConfig,
                   extract=None, key=None,
                   carried: Optional[StepGraph] = None) -> StepGraph:
    """A `StepGraph` of `tracking_step` (with `extract`, the front-end too),
    called with the arguments of `tracking_step` after the generator:
    `carried` when it was made for `key` and `generator`, else a new handle
    on the cached graph of `key`, which must name what `extract` closes
    over (configuration, device, the extract's kind)."""
    return StepGraph.reuse(
        carried,
        lambda gen, *a: tracking_step(gen, *a, cfg=cfg, extract=extract),
        generator, key)


def rgbd_extract(cfg: SystemConfig, dev):
    """The RGB-D front-end as the `extract` of `tracking_step`: it closes
    over the configuration and the device only, so a cached graph of it
    holds no system alive."""
    t = cfg.tracking
    return lambda gray, depth, intr: frontend_gray_depth(
        gray, depth, intr, cfg.frontend, min_depth=t.min_depth,
        max_depth=t.max_depth, device=dev)


_STEP_CONSTANTS: dict = {}


def step_constants(dev) -> dict:
    """Device constants the tracking graph's callers hand it: no IMU prior
    (a zero (3,) and a False flag), the True flag, int32 0 and 1.  Made once
    a device by fills, so no frame uploads them."""
    c = _STEP_CONSTANTS.get(str(dev))
    if c is None:
        c = _STEP_CONSTANTS[str(dev)] = {
            "no_imu": torch.zeros(3, dtype=torch.float32, device=dev),
            "false": torch.zeros((), dtype=torch.bool, device=dev),
            "true": torch.ones((), dtype=torch.bool, device=dev),
            "zero": torch.zeros((), dtype=torch.int32, device=dev),
            "one": torch.ones((), dtype=torch.int32, device=dev),
        }
    return c


def imu_upload(delta_w, dev) -> Tensor:
    """A host (3,) gyro rotation on `dev` with no host wait: on the card
    through pinned memory, copied without blocking."""
    x = torch.as_tensor(np.asarray(delta_w, np.float32))
    if dev.type == "cuda":
        return x.pin_memory().to(dev, non_blocking=True)
    return x.to(dev)


@torch.no_grad()
def relocalize(m: MapState, feats: Features,
               generator: Optional[torch.Generator], cfg: SystemConfig,
               device=None, uniforms: Optional[Tensor] = None,
               ) -> tuple[Tensor, Tensor]:
    """Re-pose a lost frame against the keyframe store: retrieve the most
    similar stored keyframe and solve the relative pose from scratch (no
    motion prior, so an arbitrarily wrong current estimate is recoverable).
    Returns (ok () bool, T_wc (4, 4)), both on the device.  uniforms: the
    frame's (512, 3) block (`TrackingStep.u_reloc`); without it the
    verification draws from `generator`, whether or not retrieval passed its
    gate."""
    dev = resolve_device(device)
    set_exact_f32()
    rc = cfg.reloc
    gdesc = map_mod.global_descriptor(feats.desc, feats.valid)
    cand = loop_mod.retrieve_global(m, gdesc, rc.min_sim, device=dev)
    ver = loop_mod.verify_features(
        m, feats.desc, feats.has_point, feats.points, cand.kf_idx, generator,
        rc.ransac_inlier_thresh, rc.min_inliers, rc.ransac_depth_quad,
        rc.ransac_gate_cap, uniforms=uniforms, device=dev)
    # T_ab: keyframe-camera -> query-camera; T_w_query = T_w_kf @ T_ab^-1
    T_new = loop_mod._row(m.kf_pose, cand.kf_idx) @ geo.pose_inverse(ver.T_ab)
    return cand.ok & ver.ok, T_new


class KeyframeUpdate(NamedTuple):
    """What `keyframe_update` did, for the scheduler that called it."""

    m: MapState
    T_wc: Tensor          # (4, 4) pose of the new keyframe after BA / closure
    slot: Tensor          # () its slot after any compaction
    looped: object        # a loop closed: a host int, a () bool in a graph
    compacted: object     # the map was compacted: likewise
    loop_prev_uid: Tensor  # () int32 loop gate state, to be carried into the
    loop_consist: Tensor   # () int32 next keyframe's `retrieve_and_verify`
    ba_dropped: object    # colliding edges the sharded BA dropped (0
    #                       meshless): a host int, a () tensor in a graph


def compact_if_full(m: MapState, cfg: SystemConfig, num_obs, num_lm,
                    num_kf, device=None) -> tuple[MapState, object]:
    """Recycle map capacity when a budget crosses the compact threshold:
    keyframe culling + slot recycling (`map.compact_keyframes`) when the
    keyframe table fills, then landmark culling + observation compaction
    (`map.compact_map`).  Keeps long sequences mapping inside fixed arrays
    instead of silently saturating.  The counters are host numbers, or 0-dim
    device tensors inside a FrameGraph (each step is then a branch on the
    device).  Returns (map, whether it compacted)."""
    dev = resolve_device(device)
    mc = cfg.map
    kf_full = num_kf > mc.compact_at * m.kf_valid.shape[0]
    need_compact = (kf_full | (num_obs > mc.compact_at * m.obs_valid.shape[0])
                    | (num_lm > mc.compact_at * m.lm_valid.shape[0]))
    # inside a graph a body writes into the map's tensors; eagerly it
    # replaces them, and the argument is never written
    box = Carry({"m": m}, in_place=in_graph())
    kf_cap = m.kf_valid.shape[0]
    cond(kf_full, lambda: box.set(m=map_mod.compact_keyframes(
        box.m, mc.kf_cull_redundancy, mc.kf_cull_min_covisible,
        mc.kf_protect_recent, round(mc.kf_target_fill * kf_cap),
        mc.kf_protect_loop_recent, device=dev)), name="compact_keyframes")
    cond(need_compact, lambda: box.set(m=map_mod.compact_map(
        box.m, mc.cull_min_obs, mc.cull_min_age_kf, device=dev)),
        name="compact_map")
    return box.m, need_compact


@torch.no_grad()
def keyframe_update(
    m: MapState, feats: Features, T_wc: Tensor, frame_idx, lm_idx: Tensor,
    lm_ok: Tensor, intrinsics: Tensor, cfg: SystemConfig,
    generator: Optional[torch.Generator], loop_prev_uid, loop_consist,
    sample_idx: Optional[Tensor] = None, mesh=None, device=None,
    uniforms: Optional[Tensor] = None,
) -> KeyframeUpdate:
    """The keyframe branch: insert + windowed BA + loop detection, then the
    loop closure where the verdict holds and the capacity recycling where a
    budget is crossed: branches on the device inside a FrameGraph; eagerly,
    host branches on the verdict and the counters, fetched together.

    Loop detection runs at every keyframe: retrieval's min_kf_gap exclusion
    is the recency gate and the RANSAC verification the correctness gate.
    sample_idx / uniforms: optional RANSAC samples or the frame's uniforms
    (`TrackingStep.u_loop`) for `loop.retrieve_and_verify`; without either
    the verification draws from `generator`.
    mesh: a `parallel.mesh.Mesh` on this device; the windowed BA then runs
    landmark-sharded over it (`parallel.ba_sharded.sharded_local_ba`), and
    its dropped edges ride the counters' fetch (in a graph they stay a
    device count)."""
    dev = resolve_device(device)
    set_exact_f32()
    new_mask = feats.has_point & ~lm_ok
    m, slot = map_mod.insert_keyframe(
        m, feats, T_wc, frame_idx, new_mask, lm_idx, lm_ok, device=dev)
    counters = []
    if mesh is None:
        m = local_ba(m, intrinsics, cfg.map.window_size, cfg, device=dev)
    else:
        from jetracer_orbslam2_torch.parallel.ba_sharded import sharded_local_ba

        m, dropped = sharded_local_ba(m, intrinsics, cfg.map.window_size, cfg,
                                      mesh)
        counters = [] if in_graph() else [dropped]
    cand_idx, T_ab, loop_ok, lp_uid, lp_cons = loop_mod.retrieve_and_verify(
        m, slot, generator, cfg.loop, intrinsics, loop_prev_uid, loop_consist,
        sample_idx=sample_idx, uniforms=uniforms, device=dev)
    # closing a loop changes no counter: every branch is known here
    looped, num_obs, num_lm, num_kf, *fetched = branch_values(
        loop_ok, m.num_obs, m.num_lm, m.num_kf, *counters)
    box = Carry({"m": m}, in_place=in_graph())
    cond(looped, lambda: box.set(m=loop_mod.close(
        box.m, slot, cand_idx, T_ab, cfg.pose_graph, device=dev)),
        name="loop_closure")
    # the live pose rides the optimized (and corrected) newest keyframe
    T_wc = loop_mod._row(box.m.kf_pose, slot)
    m, compacted = compact_if_full(box.m, cfg, num_obs, num_lm, num_kf, dev)
    # the new keyframe is the newest and is never culled, but its slot may
    # have moved during compaction
    return KeyframeUpdate(
        m=m, T_wc=T_wc, slot=m.num_kf - 1, looped=looped,
        compacted=compacted, loop_prev_uid=lp_uid, loop_consist=lp_cons,
        ba_dropped=dropped if mesh is not None and in_graph() else sum(fetched))


def mesh_device(mesh, device, cfg: SystemConfig) -> torch.device:
    """The device of a system that may own a mesh: the mesh's (`device` may
    name it again, not another), else `resolve_device(device)`.  Raises
    ValueError when the map's landmark capacity does not split into the
    mesh's blocks."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    if cfg.map.max_landmarks % mesh.size:
        raise ValueError(
            f"landmark capacity must divide the mesh: "
            f"L={cfg.map.max_landmarks} n={mesh.size}")
    return mesh.device


@dataclasses.dataclass
class SlamOutput:
    poses: np.ndarray          # (N, 4, 4) per-frame T_wc
    tracked: np.ndarray        # (N,) bool
    num_keyframes: int
    num_landmarks: int
    num_loops: int
    num_relocs: int = 0


class Slam:
    """Host-side SLAM orchestrator: a thin scheduler over the fixed-shape
    functions of this module, one packed fetch per frame and one more per
    keyframe.  A frame's tracking half is one replay of a captured graph on
    the card (`process_frame`: front-end and tracking; `process_features`:
    tracking of given features); it draws the frame's uniforms for the
    branches, so this loop draws what `slam_scan` draws."""

    def __init__(self, cfg: SystemConfig, intrinsics, seed: int = 0,
                 mesh=None, device=None):
        """device: None is cuda:0 (raises without a CUDA device), "cpu" on
        request.  mesh: a `parallel.mesh.Mesh`; when given, every windowed
        BA runs landmark-sharded across its ranks
        (`parallel.ba_sharded.sharded_local_ba`), the system runs on the
        mesh's device, and every rank runs this whole system in lockstep.
        The one-rank mesh runs the identical program."""
        set_exact_f32()
        self.device = mesh_device(mesh, device, cfg)
        self.mesh = mesh
        self.ba_edges_dropped = 0
        self.cfg = cfg
        self.intr = as_f32(intrinsics, self.device)
        self.m = map_mod.init_map(
            cfg.map, cfg.frontend.max_keypoints,
            cfg.frontend.num_descriptor_words, device=self.device)
        self.generator = make_generator(seed, self.device)
        self._frame_extract = rgbd_extract(cfg, self.device)
        self.prev: Optional[Features] = None
        self.T_wc = torch.eye(4, dtype=torch.float32, device=self.device)
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self.frame_idx = 0
        # () int32 on the device: the tracking graph reads and advances it
        self.frames_since_kf = step_constants(self.device)["zero"]
        self.num_loops = 0
        self.lost_streak = 0
        self.num_relocs = 0
        self.num_compactions = 0
        # loop-closure temporal-consistency gate state: uid of the last
        # keyframe's winning candidate + consecutive-detection streak (device
        # scalars once a keyframe has set them: the host never needs them)
        self._loop_prev_uid = loop_mod.NO_CANDIDATE_UID
        self._loop_consist = 0
        self.trajectory: list[np.ndarray] = []   # live (causal) estimates
        self.tracked: list[bool] = []
        # every frame is anchored to its reference keyframe: the FINAL
        # trajectory (result()) composes the frame-relative pose with the
        # keyframe's OPTIMIZED pose, so local-BA and loop-closure
        # corrections apply retroactively.  Frames record the keyframe's UID
        # (its frame_id) rather than its slot: slots are recycled by
        # compact_keyframes, uids never are.
        self.frame_ref_uid: list[int] = []
        self.frame_rel: list[np.ndarray] = []    # T_refkf_frame at record time
        self._ref_uid = 0
        self._ref_pose_np = np.eye(4, dtype=np.float32)
        # IMU attitude rides alongside the visual pipeline, and the gyro
        # feeds the tracker's motion prior (track_and_associate)
        self.imu_state = imu_mod.init_state()
        self._imu_delta_w = np.zeros(3, np.float32)
        self._imu_delta_ok = False
        # the handles on the tracking graphs (of given features, of an image
        # pair), cached per (configuration, device, kind): a second Slam of
        # the configuration replays at its first tracked frame
        self._graphs: dict = {}

    def features(self, gray, depth) -> Features:
        """Front-end entry: this system's Features from an RGB-D pair."""
        t = self.cfg.tracking
        return frontend_gray_depth(
            gray, depth, self.intr, self.cfg.frontend,
            min_depth=t.min_depth, max_depth=t.max_depth, device=self.device)

    def _try_relocalize(self, feats: Features,
                        uniforms: Optional[Tensor] = None) -> bool:
        ok, T_new = relocalize(self.m, feats, self.generator, self.cfg,
                               self.device, uniforms=uniforms)
        if not bool(ok):
            return False
        self.T_wc = T_new
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self.lost_streak = 0                   # the motion prior is stale
        self.num_relocs += 1
        return True

    def process_imu(self, packet) -> None:
        """Fold one per-frame IMU packet (gyro, gyro_ts, accel, gyro_valid,
        accel_valid) into the attitude state and latch the inter-frame gyro
        rotation for the tracker's motion prior."""
        self.imu_state, self._imu_delta_w = imu_mod.process_packet_with_delta(
            self.imu_state, *packet)
        self._imu_delta_ok = True

    @property
    def attitude(self) -> np.ndarray:
        """(3,) filtered Euler attitude [rad]."""
        return np.asarray(self.imu_state.theta)

    @torch.no_grad()
    def process_frame(self, gray, depth, imu_packet=None) -> FrameReport | None:
        """Feed one RGB-D frame.  Returns the per-frame report (None for
        the very first frame, which only bootstraps).  After the first frame
        the front-end and the tracking step are one graph replay."""
        if self.prev is None:
            return self.process_features(
                self.features(gray, depth), imu_packet=imu_packet)
        if imu_packet is not None:
            self.process_imu(imu_packet)
        frame = (as_f32(gray, self.device), as_f32(depth, self.device))
        return self._track(frame, self._graph("rgbd", self._frame_extract))

    def _graph(self, name: str, extract=None) -> StepGraph:
        g = self._graphs[name] = tracking_graph(
            self.generator, self.cfg, extract,
            key=(self.cfg, self.device, name), carried=self._graphs.get(name))
        return g

    @torch.no_grad()
    def process_features(
        self, feats: Features, imu_packet=None,
    ) -> FrameReport | None:
        """Feed one already-extracted feature set (after the first frame,
        its tracking step is one graph replay)."""
        if imu_packet is not None:
            self.process_imu(imu_packet)
        feats = _features_to(feats, self.device)
        if self.prev is not None:
            return self._track(feats, self._graph("features"))
        self.prev = feats
        self.trajectory.append(self.T_wc.cpu().numpy())
        self.tracked.append(True)
        # bootstrap keyframe: everything with depth becomes a landmark
        k = feats.xy.shape[0]
        self.m, _ = map_mod.insert_keyframe(
            self.m, feats, self.T_wc, self.frame_idx, feats.has_point,
            torch.zeros(k, dtype=torch.int32, device=self.device),
            torch.zeros(k, dtype=torch.bool, device=self.device),
            device=self.device)
        self._ref_uid = self.frame_idx          # kf uid == frame id
        self._ref_pose_np = self.trajectory[-1]
        self.frame_ref_uid.append(self._ref_uid)
        self.frame_rel.append(np.eye(4, dtype=np.float32))
        self.frame_idx += 1
        return None

    def _track(self, frame, graph: StepGraph) -> FrameReport:
        """One tracked frame: the graph's replay, the ONE fetch, then the
        host's branches.  `frame` is Features, or an image pair for a graph
        that runs the front-end."""
        const = step_constants(self.device)
        ok_imu = self._imu_delta_ok
        # the lost streak stays a host int: this loop's one fetch is
        # report.packed (it carries the pose for the trajectory), and the
        # streak follows from its `ok` with no second fetch, so the step's
        # device streak and flags (slam_scan's) are not read here
        step = graph(
            self.prev, frame, self.m, self.T_wc, self.velocity,
            imu_upload(self._imu_delta_w, self.device) if ok_imu
            else const["no_imu"], const["true" if ok_imu else "false"],
            self.frames_since_kf, const["zero"], self.intr)
        feats = frame if step.feats is None else step.feats
        report, lm_idx, lm_ok = step.report, step.lm_idx, step.lm_ok
        self._imu_delta_ok = False    # consume the prior (one per packet)
        self.T_wc = report.T_wc
        self.velocity = step.velocity
        self.prev = feats
        self.frames_since_kf = step.since_kf
        # ONE device->host fetch per frame: every scheduler decision rides
        # report.packed
        pk = report.packed.cpu().numpy()
        ok, need_kf = bool(pk[0] > 0.5), bool(pk[1] > 0.5)
        self.trajectory.append(pk[4:].reshape(4, 4).astype(np.float32))
        self.tracked.append(ok)

        if ok:
            self.lost_streak = 0
        else:
            self.lost_streak += 1
            if self.lost_streak >= self.cfg.reloc.after_frames:
                if self._try_relocalize(feats, step.u_reloc):
                    self.trajectory[-1] = self.T_wc.cpu().numpy()

        if need_kf:
            up = keyframe_update(
                self.m, feats, self.T_wc, self.frame_idx, lm_idx, lm_ok,
                self.intr, self.cfg, self.generator, self._loop_prev_uid,
                self._loop_consist, mesh=self.mesh, device=self.device,
                uniforms=step.u_loop)
            self.m, self.T_wc = up.m, up.T_wc
            self.ba_edges_dropped += up.ba_dropped
            self.frames_since_kf = const["one"]     # 1 after this keyframe
            self._loop_prev_uid = up.loop_prev_uid
            self._loop_consist = up.loop_consist
            self.num_loops += up.looped
            self.num_compactions += up.compacted
            T_np = self.T_wc.cpu().numpy()
            self.trajectory[-1] = T_np
            self._ref_uid = self.frame_idx          # kf uid == frame id
            self._ref_pose_np = T_np

        self.frame_ref_uid.append(self._ref_uid)
        self.frame_rel.append(
            np.linalg.inv(self._ref_pose_np).astype(np.float32)
            @ self.trajectory[-1])
        self.frame_idx += 1
        return report

    def result(self) -> SlamOutput:
        """Final trajectory: each frame rides its reference keyframe's
        OPTIMIZED pose, so the whole history reflects every local BA and
        loop closure that happened after the frame was live.  Reference
        keyframes culled by compact_keyframes resolve through the retired
        ring; on ring overflow the frame falls back to its live (causal)
        estimate."""
        table = map_mod.resolve_kf_poses(self.m)
        poses = np.stack([
            table[ref] @ rel if ref in table else live
            for ref, rel, live in zip(
                self.frame_ref_uid, self.frame_rel, self.trajectory)
        ])
        return SlamOutput(
            poses=poses,
            tracked=np.asarray(self.tracked),
            num_keyframes=int(self.m.num_kf),
            num_landmarks=int(self.m.num_lm),
            num_loops=self.num_loops,
            num_relocs=self.num_relocs,
        )
