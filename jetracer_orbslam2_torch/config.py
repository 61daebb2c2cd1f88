"""Static configuration of the port (counterpart of
`jetracer_orbslam2_tpu/config.py`, kept as the port's own copy).

Frozen dataclasses: every field that shapes a tensor is a Python int/float,
so one config object pins every shape on the compute path (fixed K keypoints
plus validity masks, fixed RANSAC hypothesis count).  Only the dataclasses the
ported modules read live here; the map/BA/loop/stereo configs arrive with
their modules.
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
    # color<-depth extrinsic as 16 row-major floats).  The fields are kept
    # for layout parity; the port's frontend does not yet re-render depth
    # and raises NotImplementedError when depth_intrinsics is set.
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
