"""Static configuration of the port (counterpart of
`jetracer_orbslam2_tpu/config.py`, kept as the port's own copy).

Frozen dataclasses: every field that shapes a tensor is a Python int/float,
so one config object pins every shape on the compute path (fixed K keypoints
plus validity masks, fixed RANSAC hypothesis count, fixed map capacities).
The dataclasses are the JAX package's field for field, so one `SystemConfig`
describes the same system in both; a test compares the defaults.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """ORB front-end geometry and budgets.

    A 16 px NMS grid over a 4-level half-sampled pyramid, FAST epsilon 13 with
    a 12-pixel arc, 1024 keypoints, full 256-bit descriptors.
    """

    height: int = 480
    width: int = 640
    num_levels: int = 4             # pyramid levels, halfsample per level
    cell_size: int = 16             # grid-NMS cell
    max_keypoints: int = 1024       # total feature budget across levels
    fast_threshold: float = 13.0    # FAST epsilon
    # two-threshold adaptive detection (ORB-SLAM2's iniThFAST/minThFAST):
    # when > 0, cells where no corner passes fast_threshold fall back to
    # the winner at this lower epsilon, so texture-poor views keep enough
    # features to track.  0 = off.  Costs one extra FAST+NMS pass per level.
    fast_min_threshold: float = 0.0
    fast_arc_length: int = 12       # contiguous ring arc
    fast_border: int = 19           # keep-out border at each level (patch radius + ring)
    patch_size: int = 37            # orientation/BRIEF patch (must be odd)
    num_angle_bins: int = 32        # rotated-BRIEF quantization (11.25 deg)
    descriptor_bits: int = 256      # full BRIEF-256
    min_score: float = 1e-3         # validity cutoff for cell winners
    # camera distortion of the primary camera, applied at the keypoint
    # level: detection runs on the RAW image, keypoint COORDS are
    # undistorted once (ops/geometry.undistort_pixels).
    #   brown_conrady: (k1, k2, p1, p2, k3);  ftheta: (w,)
    # None = pre-rectified input.
    dist: Optional[Tuple[float, ...]] = None
    dist_model: str = "brown_conrady"
    # UNREGISTERED depth camera calibration (depth intrinsics, distortion,
    # color<-depth extrinsic as 16 row-major floats).  When depth_intrinsics
    # is set, the frontend re-renders each depth map into the color camera
    # first (ops/align.align_depth_to_color).
    depth_intrinsics: Optional[Tuple[float, ...]] = None
    depth_dist: Optional[Tuple[float, ...]] = None
    T_color_depth: Optional[Tuple[float, ...]] = None

    @property
    def patch_radius(self) -> int:
        return self.patch_size // 2

    @property
    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        shapes = []
        h, w = self.height, self.width
        for _ in range(self.num_levels):
            shapes.append((h, w))
            h, w = (h + 1) // 2, (w + 1) // 2
        return tuple(shapes)

    @property
    def level_cells(self) -> Tuple[Tuple[int, int], ...]:
        """(rows, cols) of NMS cells per level."""
        return tuple(
            (math.ceil(h / self.cell_size), math.ceil(w / self.cell_size))
            for (h, w) in self.level_shapes
        )

    @property
    def total_cells(self) -> int:
        return sum(r * c for (r, c) in self.level_cells)

    @property
    def num_descriptor_words(self) -> int:
        return self.descriptor_bits // 32


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Frame-to-frame tracking gates and budgets."""

    match_window: float = 48.0          # px reprojection gate
    match_max_hamming: int = 64         # of 256 bits
    match_ratio: float = 0.9            # best/second-best Lowe ratio
    ransac_iters: int = 256             # batched hypotheses (Kabsch on 3-pt sets)
    ransac_inlier_thresh: float = 0.05  # m, 3D-3D inlier distance
    # depth-dependent widening of the 3D inlier gate: effective threshold
    # is ransac_inlier_thresh + ransac_depth_quad * z^2 (stereo/ToF depth
    # error grows quadratically with range).
    ransac_depth_quad: float = 0.02     # m^-1
    # Gauss-Newton iterations of the motion-only reprojection polish
    # against the MAP (read by the SLAM path, not by odometry).
    map_polish_iters: int = 5
    min_matches: int = 12
    min_inliers: int = 8
    max_depth: float = 8.0              # m, reject far/invalid depth
    min_depth: float = 0.05


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity keyframe/landmark store."""

    max_keyframes: int = 256
    max_landmarks: int = 16384
    max_obs: int = 65536
    kf_min_inlier_ratio: float = 0.35   # spawn KF when tracked ratio drops
    kf_min_gap: int = 5                 # frames between keyframes
    kf_max_gap: int = 30                # force a KF after this many frames
    window_size: int = 8                # local-BA keyframe window
    # landmark culling / observation recycling (map.compact_map): cull
    # landmarks >= cull_min_age_kf keyframes old with < cull_min_obs
    # observations whenever a capacity passes compact_at of its budget.
    cull_min_obs: int = 3
    cull_min_age_kf: int = 3
    compact_at: float = 0.8
    # keyframe culling / slot recycling (map.compact_keyframes): when the
    # keyframe table passes compact_at of its budget, cull redundant
    # keyframes (>= kf_cull_redundancy of their observed landmarks are
    # covisible from >= kf_cull_min_covisible OTHER keyframes — the
    # ORB-SLAM2 redundant-KF rule) and, under capacity pressure, force the
    # most redundant ones out until only kf_target_fill of the table is
    # occupied.  Slot 0 (gauge), the newest kf_protect_recent slots (the BA
    # window) and loop-edge endpoints are never culled.  Culled keyframes
    # retire into a bounded ring (uid + pose relative to a surviving
    # anchor) so trajectory anchoring stays exact across recycling.
    kf_cull_redundancy: float = 0.9
    kf_cull_min_covisible: int = 3
    kf_protect_recent: int = 8
    kf_target_fill: float = 0.75
    # endpoints of only the newest N loop edges are protected from culling
    # (permanent protection of every edge ever accepted would shrink the
    # cullable set until capacity-pressure eviction stops working on long
    # many-loop runs); an older edge whose endpoint is culled is dropped —
    # its correction is already baked into the optimized pose chain.
    kf_protect_loop_recent: int = 8
    max_dead_keyframes: int = 2048
    # retained loop-closure constraints (KITTI-00-class sequences close
    # many loops; every pose-graph solve re-applies ALL accepted edges)
    max_loop_edges: int = 32


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Levenberg–Marquardt with Schur complement over landmark blocks."""

    iters: int = 10
    damping_init: float = 1e-3
    damping_up: float = 10.0
    damping_down: float = 0.1
    huber_delta: float = 5.991 ** 0.5   # px, chi2 95% for 2-dof


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    iters: int = 20
    damping: float = 1e-6
    # relative weight of loop-closure edges vs odometry chain edges in the
    # pose-graph objective
    loop_weight: float = 4.0


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """Retrieval gate + geometric verification for loop closure.

    `min_sim` is the centered-cosine retrieval threshold (global descriptors
    are mean BRIEF bit vectors; centering at 0.5 turns cosine into a
    correlation, which separates revisits from merely-same-room views —
    validated on the synthetic lap in tests/test_loop_closure.py)."""

    min_sim: float = 0.55               # centered-cosine retrieval gate
    min_kf_gap: int = 10                # don't match the last N keyframes
    ransac_inlier_thresh: float = 0.10
    # depth-scaled widening of the verification gate, same sensor model as
    # TrackingConfig.ransac_depth_quad: loop pairs are often far geometry
    # (the revisit is seen across the room), exactly where a fixed metric
    # gate starves the RANSAC
    ransac_depth_quad: float = 0.02
    min_inliers: int = 20
    # hardening against perceptual aliasing:
    # top-N retrieval shortlist with batched geometric verification (the
    # best-RANSAC candidate wins, so an aliased near-duplicate at rank 1
    # cannot shadow the true revisit), a temporal-consistency gate
    # (ORB-SLAM2's consecutive-detection rule: the winning candidate must
    # lie within consistency_window FRAMES of the previous keyframe's
    # winning candidate for min_consistency consecutive keyframes), and a
    # world-frame check (the candidate's landmarks at their CURRENT
    # post-BA positions must reproject into the query under the
    # hypothesized pose — kf_points alone are frozen at insert time).
    topn: int = 3
    min_consistency: int = 2
    consistency_window: int = 45        # frames (keyframe-uid distance)
    world_window: float = 16.0          # px reprojection gate, world check
    world_min_inliers: int = 10
    world_max_obs: int = 256            # landmarks gathered per candidate


@dataclasses.dataclass(frozen=True)
class RelocConfig:
    """Relocalization on tracking loss: after `after_frames` consecutive
    failed tracks, retrieve the most similar keyframe (same global
    descriptor as loop closure, no recency exclusion) and re-pose against
    it with the loop-verification RANSAC."""

    after_frames: int = 3               # consecutive lost frames before trying
    min_sim: float = 0.4                # retrieval gate (looser than loops:
    #                                     geometric RANSAC does the vetting)
    ransac_inlier_thresh: float = 0.10
    ransac_depth_quad: float = 0.02     # see LoopClosureConfig
    # cap on the depth-widened inlier gate: unlike loop closure there is
    # no world-frame reprojection backstop on the reloc accept path, and
    # an uncapped 0.02*z^2 grows to ~1.4 m at the 8 m depth cap — far
    # geometry would accept near-arbitrary poses
    ransac_gate_cap: float = 0.5        # m
    min_inliers: int = 15


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Stereo rig for the on-device scan paths (models/slam_scan with
    SystemConfig.stereo set): the per-frame input pair is (left, right)
    grayscale and depth comes from epipolar-gated descriptor matching +
    subpixel SAD refinement (models/stereo.frontend_stereo): the
    EuRoC/KITTI generalization of the RGB-D depth association.

    All fields are static (floats/tuples) so a SystemConfig carrying one
    stays hashable and pins the compiled program.  rect/dist fields
    support non-pre-rectified rigs via keypoint-level rectification —
    None means the pair is already rectified (KITTI, processed EuRoC)."""

    baseline: float = 0.11              # m (EuRoC ~0.11, KITTI ~0.54)
    max_disparity: float = 128.0        # px
    epipolar_tol: float = 2.0           # px row tolerance
    max_hamming: int = 48               # of 256 bits, L-R match gate
    dist_r: Optional[Tuple[float, ...]] = None      # right-cam distortion
    rect_l: Optional[Tuple[float, ...]] = None      # (9,) row-major R_l
    rect_r: Optional[Tuple[float, ...]] = None      # (9,) row-major R_r
    intrinsics_r: Optional[Tuple[float, ...]] = None  # right (fx,fy,cx,cy)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Host pipeline: queue caps and backpressure."""

    queue_capacity: int = 5
    drop_when_full: bool = True
    prefetch_frames: int = 4
    telemetry_port: int = 9002          # WebSocket port
    telemetry_rate_bytes: int = 5_000_000


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    pose_graph: PoseGraphConfig = dataclasses.field(default_factory=PoseGraphConfig)
    loop: LoopClosureConfig = dataclasses.field(default_factory=LoopClosureConfig)
    reloc: RelocConfig = dataclasses.field(default_factory=RelocConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    # stereo rig: when set, the scan paths (slam_scan / ChunkedSlam) read
    # each frame as a (left, right) pair instead of (gray, depth)
    stereo: Optional[StereoConfig] = None

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)
