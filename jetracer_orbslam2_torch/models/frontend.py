"""ORB front-end: image -> fixed-K features.

Counterpart of `jetracer_orbslam2_tpu/models/frontend.py`: gray -> blur ->
pyramid -> FAST+NMS (the hand-written kernel, once per frame for every level
and both thresholds) -> grid NMS -> top-K -> patches (the hand-written gather
kernel, once per frame, straight from the pyramid levels) -> orientation
-> BRIEF-256 -> (depth-to-colour alignment for an unregistered depth camera)
-> backprojection.
Eager PyTorch on one stream; nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jetracer_orbslam2_torch.config import FrontendConfig
from jetracer_orbslam2_torch.ops import (
    align, fused_fast, fused_patches, geometry as geo, nms, orb, preprocess)
from jetracer_orbslam2_torch.ops.nms import Keypoints
from jetracer_orbslam2_torch.utils.consts import const_table
from jetracer_orbslam2_torch.utils.device import as_f32, resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32

Tensor = torch.Tensor


class Features(NamedTuple):
    """Fixed-K per-frame feature set.

    `xy` is in IDEAL-PINHOLE pixel coordinates: when the camera has
    distortion (FrontendConfig.dist), detection runs on the raw image and
    the keypoint coords are undistorted here, once."""

    xy: Tensor       # (K, 2) float32 level-0 ideal-pinhole pixel coords
    level: Tensor    # (K,) int32
    score: Tensor    # (K,) float32
    angle: Tensor    # (K,) float32 radians
    desc: Tensor     # (K, 8) int32 packed BRIEF-256 (uint32 bit pattern)
    valid: Tensor    # (K,) bool detection validity
    points: Tensor   # (K, 3) float32 camera-frame 3D (0 if no depth)
    has_point: Tensor  # (K,) bool valid AND has usable depth


def pyramid_levels(gray: Tensor, cfg: FrontendConfig) -> list[Tensor]:
    """3x3 blur, then the half-sampled pyramid (contiguous levels)."""
    blurred = preprocess.gaussian_blur_3x3(gray)
    return [img.contiguous()
            for img in preprocess.build_pyramid(blurred, cfg.num_levels)]


def fast_responses(levels: list[Tensor], cfg: FrontendConfig):
    """FAST + 3x3 NMS of every level in `levels` at the configuration's
    thresholds: out[threshold][level], in one kernel launch for every
    `fused_fast.MAX_LEVELS` levels (one launch for a 4-level pyramid, and for
    both pyramids of a stereo pair).

    Two-threshold adaptive detection (ORB-SLAM2 iniThFAST / minThFAST):
    cells empty at the primary epsilon take the low-epsilon winner, so
    texture-poor views keep features."""
    thresholds = [cfg.fast_threshold]
    if cfg.fast_min_threshold > 0.0:
        thresholds.append(cfg.fast_min_threshold)
    out = [[] for _ in thresholds]
    for at in range(0, len(levels), fused_fast.MAX_LEVELS):
        part = fused_fast.fast_nms_pyramid(
            levels[at:at + fused_fast.MAX_LEVELS], thresholds,
            cfg.fast_arc_length, cfg.fast_border)
        for row, got in zip(out, part):
            row.extend(got)
    return out


def describe_levels(levels: list[Tensor], resp, cfg: FrontendConfig
                    ) -> tuple[Keypoints, Tensor, Tensor]:
    """Grid NMS, top-K, patches, orientation and BRIEF of one image, from its
    pyramid and its FAST responses.  Returns (keypoints, angles, descriptors)."""
    winners = []
    for i, primary in enumerate(resp[0]):
        hi = nms.grid_nms(primary, cfg.cell_size, suppress=False)
        if len(resp) > 1:
            lo = nms.grid_nms(resp[1][i], cfg.cell_size, suppress=False)
            use_hi = hi.score > cfg.min_score
            hi = nms.CellWinners(
                score=torch.where(use_hi, hi.score, lo.score),
                y=torch.where(use_hi, hi.y, lo.y),
                x=torch.where(use_hi, hi.x, lo.x))
        winners.append(hi)
    kp = nms.select_keypoints(
        winners, cfg.level_shapes, cfg.max_keypoints, cfg.min_score, cfg.fast_border
    )
    patch = fused_patches.extract_patches_fused(levels, kp, cfg.patch_size)
    angles = orb.orientation(patch)
    desc = orb.describe(patch, angles, cfg.descriptor_bits, cfg.num_angle_bins)
    return kp, angles, desc


def extract_features(
    gray: Tensor,
    cfg: FrontendConfig,
) -> tuple[Keypoints, Tensor, Tensor]:
    """Detect + describe on a grayscale image: one FAST+NMS launch for every
    level and both thresholds, one patch-gather launch.

    Returns (keypoints, angles, descriptors).
    """
    levels = pyramid_levels(gray, cfg)
    return describe_levels(levels, fast_responses(levels, cfg), cfg)


def calib_table(name: str, values, dev):
    """A calibration tuple (or array) as a cached f32 tensor on `dev`; None
    stays None."""
    if values is None:
        return None
    arr = np.asarray(values, np.float32)
    return const_table((name, tuple(arr.ravel().tolist())), lambda: arr, dev)


@torch.no_grad()
def frontend_rgbd(
    rgb: Tensor,
    depth: Tensor,
    intrinsics: Tensor,
    cfg: FrontendConfig,
    min_depth: float = 0.05,
    max_depth: float = 8.0,
    device=None,
) -> Features:
    """Full RGB-D front-end: (H, W, 3) rgb + (H, W) depth [m] -> Features.
    Runs on `cuda:0` unless `device` says otherwise."""
    dev = resolve_device(device)
    gray = preprocess.rgb_to_gray(torch.as_tensor(rgb).to(dev))
    return frontend_gray_depth(gray, depth, intrinsics, cfg, min_depth,
                               max_depth, device=dev)


@torch.no_grad()
def frontend_gray_depth(
    gray: Tensor,
    depth: Tensor,
    intrinsics: Tensor,
    cfg: FrontendConfig,
    min_depth: float = 0.05,
    max_depth: float = 8.0,
    device=None,
) -> Features:
    """(H, W) gray + (H, W) registered depth [m] -> Features.

    Runs on `cuda:0` (raising without one) unless `device` says otherwise;
    inputs may be numpy arrays or tensors on any device."""
    set_exact_f32()
    dev = resolve_device(device)
    gray = as_f32(gray, dev)
    depth = as_f32(depth, dev)
    intrinsics = as_f32(intrinsics, dev)
    kp, angles, desc = extract_features(gray, cfg)
    # camera distortion (cfg.dist): depth is registered to the RAW image,
    # so sampling happens at raw coords; deprojection undistorts the ray
    # and the published keypoint coords are ideal-pinhole.
    dist = calib_table("dist", cfg.dist, dev)
    if cfg.depth_intrinsics is not None:
        # UNREGISTERED depth camera: re-render the depth map into the colour
        # frame first
        depth = align.align_depth_to_color(
            depth, calib_table("depth_intrinsics", cfg.depth_intrinsics, dev),
            intrinsics,
            calib_table("T_color_depth", cfg.T_color_depth, dev).reshape(4, 4),
            tuple(gray.shape),
            depth_dist=calib_table("depth_dist", cfg.depth_dist, dev),
            color_dist=dist, device=dev)
    pts, has_depth = align.backproject_keypoints(
        kp.xy, depth, intrinsics, dist=dist, model=cfg.dist_model,
        min_depth=min_depth, max_depth=max_depth
    )
    xy = kp.xy if dist is None else geo.undistort_pixels(
        kp.xy, intrinsics, dist, cfg.dist_model)
    has_point = kp.valid & has_depth
    return Features(
        xy=xy,
        level=kp.level,
        score=kp.score,
        angle=angles,
        desc=desc,
        valid=kp.valid,
        points=torch.where(has_point[:, None], pts, torch.zeros_like(pts)),
        has_point=has_point,
    )
