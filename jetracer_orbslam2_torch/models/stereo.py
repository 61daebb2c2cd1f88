"""Stereo front-end: keypoint depth from left-right matching.

Counterpart of `jetracer_orbslam2_tpu/models/stereo.py`.  Features are
extracted in both images (one FAST+NMS launch for both pyramids of up to 4
levels each, one patch-gather launch each), matched by Hamming distance
under an epipolar gate (|v_l - v_r| small, disparity in (0.1,
max_disparity]), polished by a 1-D subpixel SAD search and turned into depth
by z = fx * baseline / disparity.  The result is a `Features` set of the
RGB-D structure, so tracking, mapping and BA do not care where depth came
from.

Rigs that are not pre-rectified are handled at the keypoint level: detection
runs on the raw images, and the keypoint COORDINATES are undistorted and
rotated into the common rectified frame (`rect_l` / `rect_r`, from
`io/datasets.stereo_rectify_rotations`); pixels never resample.

Everything here is eager PyTorch on the device of the images, with no value
read back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from jetracer_orbslam2_torch.config import FrontendConfig
from jetracer_orbslam2_torch.models.frontend import (
    Features, calib_table, describe_levels, fast_responses, pyramid_levels)
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.ops import match as match_ops
from jetracer_orbslam2_torch.utils.consts import const_table
from jetracer_orbslam2_torch.utils.device import as_f32, resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32
from jetracer_orbslam2_torch.utils.ties import first_argmin

Tensor = torch.Tensor


def extract_features_pair(left: Tensor, right: Tensor, cfg: FrontendConfig):
    """`extract_features` on both images of a pair, with both pyramids in one
    `fast_responses` call: ONE FAST+NMS launch for two pyramids of up to 4
    levels, which on the card takes 25.0 us against 29.4 us for one launch an
    image (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 6), with equal
    outputs.  Returns ((kp, angles, desc) left, (...) right)."""
    lv = [pyramid_levels(left, cfg), pyramid_levels(right, cfg)]
    n = len(lv[0])
    resp = fast_responses(lv[0] + lv[1], cfg)
    parts = [[r[:n] for r in resp], [r[n:] for r in resp]]
    return tuple(describe_levels(levels, part, cfg)
                 for levels, part in zip(lv, parts))


def _shift_tables(patch_w: int, search: int, step: float):
    """The candidate shifts s of the SAD search and, per shift, the strip
    columns and weights of its linearly interpolated window: window column c
    is (1 - frac) * strip[k + c] + frac * strip[min(k + 1, 2 * search) + c]
    with k = floor(s) + search (the reference's per-shift slices, as one
    table).  Strip column j sits at x offset j - patch_w // 2 - search.
    Returns (shifts (S,), column offsets (2, S, pw) int64, weights (2, S))."""
    shifts = np.arange(-search, search + 1e-6, step, dtype=np.float32)
    fl = np.floor(shifts)
    k0 = fl.astype(np.int64) + search
    k1 = np.minimum(k0 + 1, 2 * search)
    frac = (shifts - fl).astype(np.float32)
    c = np.arange(patch_w)
    base = -(patch_w // 2) - search
    cols = np.stack([k0[:, None] + c, k1[:, None] + c]) + base
    weights = np.stack([np.float32(1.0) - frac, frac])
    return shifts, cols, weights


def _refine_right_x(
    left: Tensor, right: Tensor, xl: Tensor, yl: Tensor, xr0: Tensor,
    yr: Tensor, level: Tensor,
    patch_h: int = 5, patch_w: int = 9, search: int = 3, step: float = 0.25,
) -> tuple[Tensor, Tensor]:
    """Photometric subpixel correspondence refinement (batched, 1-D).

    For each keypoint, the (patch_h, patch_w) left patch at integer (xl, yl)
    is held against right windows around (xr0, yr) shifted by `step`-px
    steps in [-search, search] (linear interpolation along the row), and the
    shift of least SAD wins (first on ties).  All S windows come from one
    gather through a constant table of column offsets.

    Returns (xr0 + s_best, valid): the refined right x-coordinate, and
    whether to trust it: the windows stayed inside both images, the optimum
    is interior (not railed at the search bound), and the correction is
    within the keypoint's grid-quantization bound (a level-k coordinate is a
    multiple of 2^k).
    """
    dev = left.device
    H, W = left.shape
    ph2, pw2 = patch_h // 2, patch_w // 2
    key = ("stereo_shifts", patch_w, search, step)
    tables = [const_table(key + (i,), (lambda i=i: _shift_tables(
        patch_w, search, step)[i]), dev) for i in range(3)]
    shifts, col_off, weights = tables            # (S,), (2, S, pw), (2, S)

    dy = torch.arange(-ph2, ph2 + 1, device=dev)
    dxp = torch.arange(-pw2, pw2 + 1, device=dev)
    xl, yl, xr0, yr = xl.long(), yl.long(), xr0.long(), yr.long()
    rows_l = torch.clamp(yl[:, None] + dy, 0, H - 1)              # (K, ph)
    cols_l = torch.clamp(xl[:, None] + dxp, 0, W - 1)             # (K, pw)
    patch_l = left[rows_l[:, :, None], cols_l[:, None, :]]        # (K, ph, pw)
    rows_r = torch.clamp(yr[:, None] + dy, 0, H - 1)              # (K, ph)
    cols_r = torch.clamp(xr0[:, None, None, None] + col_off, 0, W - 1)
    flat = rows_r[:, :, None, None, None] * W + cols_r[:, None]   # (K,ph,2,S,pw)
    pair = torch.take(right, flat)
    w = weights[:, :, None]                                       # (2, S, 1)
    win = w[0] * pair[:, :, 0] + w[1] * pair[:, :, 1]             # (K,ph,S,pw)
    sad = torch.abs(patch_l[:, :, None, :] - win).sum(dim=(1, 3))  # (K, S)
    _, best = first_argmin(sad, dim=1)
    s_best = shifts.index_select(0, best)
    inside = ((yl - ph2 >= 0) & (yl + ph2 < H)
              & (yr - ph2 >= 0) & (yr + ph2 < H)
              & (xl - pw2 >= 0) & (xl + pw2 < W)
              & (xr0 - pw2 - search >= 0) & (xr0 + pw2 + search < W))
    interior = torch.abs(s_best) < (search - 0.5)
    bound = torch.exp2(level.to(torch.float32)) * 0.75 + 0.25
    within = torch.abs(s_best) <= bound
    return xr0.to(torch.float32) + s_best, inside & interior & within


def _refine_disparity(
    left: Tensor, right: Tensor, xy_l: Tensor, disp0: Tensor, level: Tensor,
) -> Tensor:
    """Rectified-path disparity refinement (ORB-SLAM2's 1-D SAD polish).

    Descriptor matching quantizes disparity to the keypoint grid (a level-k
    keypoint's x is a multiple of 2^k).  Rows align in a rectified pair, so
    the right window is taken on the LEFT row.  Returns the refined (K,)
    disparity; keypoints whose refinement is not trusted keep disp0.
    """
    xl = torch.round(xy_l[:, 0]).to(torch.int32)
    yl = torch.round(xy_l[:, 1]).to(torch.int32)
    xr0 = xl - torch.round(disp0).to(torch.int32)
    xr_ref, ok = _refine_right_x(left, right, xl, yl, xr0, yl, level)
    return torch.where(ok, xl.to(torch.float32) - xr_ref, disp0)


def _epipolar_match(xy_l, xy_r, valid_l, valid_r, desc_l, desc_r, bits: int,
                    epipolar_tol: float, max_disparity: float,
                    max_hamming: int) -> tuple[Tensor, Tensor]:
    """Epipolar-gated Hamming matching (rows align in the rectified frame):
    each left keypoint's nearest right descriptor among the right keypoints
    within `epipolar_tol` rows and at a disparity in (0.1, max_disparity],
    first index on ties.  Returns (best_j (K,) int64, matched (K,) bool)."""
    d = match_ops.hamming_matrix(desc_l, desc_r, bits)
    dv = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    gate = (
        (~valid_l[:, None]) | (~valid_r[None, :])
        | (dv > epipolar_tol)
        | (disp <= 0.1) | (disp > max_disparity)
    )
    d = torch.where(gate, torch.full_like(d, 1e9), d)
    best_d, best_j = first_argmin(d, dim=1)
    return best_j, (best_d <= max_hamming) & valid_l


@torch.no_grad()
def frontend_stereo(
    left,
    right,
    intrinsics,
    baseline: float,
    cfg: FrontendConfig,
    max_disparity: float = 128.0,
    epipolar_tol: float = 2.0,
    max_hamming: int = 48,
    min_depth: float = 0.1,
    max_depth: float = 80.0,
    dist_r: tuple | None = None,
    rect_l: tuple | None = None,
    rect_r: tuple | None = None,
    intrinsics_r=None,
    device=None,
) -> Features:
    """(H, W) left / right grayscale -> Features with stereo depth.

    `cfg.dist` / `dist_r` are the cameras' distortion coefficients and
    `rect_l` / `rect_r` row-major (9,) rectifying rotations; with all four
    None the pair is taken as pre-rectified.  The output `xy` are
    rectified-left pixel coordinates with the LEFT camera's intrinsics.
    Runs on `cuda:0` (raising without one) unless `device` says otherwise;
    inputs may be numpy arrays or tensors on any device.
    """
    set_exact_f32()
    dev = resolve_device(device)
    left = as_f32(left, dev)
    right = as_f32(right, dev)
    intrinsics = as_f32(intrinsics, dev)
    (kp_l, ang_l, desc_l), (kp_r, _, desc_r) = extract_features_pair(
        left, right, cfg)

    dist_l = calib_table("dist", cfg.dist, dev)
    d_r = calib_table("dist", dist_r, dev)
    R_l, R_r = (None if r is None else calib_table("rect", r, dev).reshape(3, 3)
                for r in (rect_l, rect_r))
    if intrinsics_r is None:
        intr_r = intrinsics
    elif isinstance(intrinsics_r, torch.Tensor):
        intr_r = as_f32(intrinsics_r, dev)
    else:                       # a calibration tuple: uploaded once
        intr_r = calib_table("intrinsics_r", intrinsics_r, dev)
    prerectified = (dist_l is None and d_r is None
                    and R_l is None and R_r is None)
    if prerectified:
        xy_l, xy_r = kp_l.xy, kp_r.xy
    else:
        xy_l = geo.undistort_pixels(
            kp_l.xy, intrinsics, dist_l, cfg.dist_model, R_l)
        xy_r = geo.undistort_pixels(
            kp_r.xy, intr_r, d_r, cfg.dist_model, R_r)

    best_j, matched = _epipolar_match(
        xy_l, xy_r, kp_l.valid, kp_r.valid, desc_l, desc_r,
        cfg.descriptor_bits, epipolar_tol, max_disparity, max_hamming)
    xy_rb = xy_r.index_select(0, best_j)
    disparity = xy_l[:, 0] - xy_rb[:, 0]
    if prerectified:
        disparity = _refine_disparity(left, right, kp_l.xy, disparity,
                                      kp_l.level)
    else:
        # the photometric polish runs on the RAW images: over the +-3 px
        # search the epipolar curve is locally row-aligned, so the 1-D search
        # slides along the raw right row through the matched keypoint, and
        # the refined raw point maps back through the rectification
        raw_rb = kp_r.xy.index_select(0, best_j)
        xr_ref, ok = _refine_right_x(
            left, right,
            torch.round(kp_l.xy[:, 0]).to(torch.int32),
            torch.round(kp_l.xy[:, 1]).to(torch.int32),
            torch.round(raw_rb[:, 0]).to(torch.int32),
            torch.round(raw_rb[:, 1]).to(torch.int32),
            torch.maximum(kp_l.level, kp_r.level.index_select(0, best_j)))
        ref_rect = geo.undistort_pixels(
            torch.stack([xr_ref, raw_rb[:, 1]], -1),
            intr_r, d_r, cfg.dist_model, R_r)
        disparity = torch.where(ok, xy_l[:, 0] - ref_rect[:, 0], disparity)
    z = intrinsics[0] * baseline / torch.clamp(disparity, min=1e-3)
    has_depth = matched & (z > min_depth) & (z < max_depth)

    pts = geo.deproject(xy_l, z, intrinsics)
    return Features(
        xy=xy_l,
        level=kp_l.level,
        score=kp_l.score,
        angle=ang_l,
        desc=desc_l,
        valid=kp_l.valid,
        points=torch.where(has_depth[:, None], pts, torch.zeros_like(pts)),
        has_point=has_depth,
    )
