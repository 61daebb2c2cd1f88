"""Frame-to-frame RGB-D tracking: matching -> RANSAC-Kabsch -> pose.

Counterpart of `jetracer_orbslam2_tpu/models/tracking.py`.

Pose conventions: `T_ab` maps points from frame b to frame a
(p_a = T_ab @ p_b).  World pose of a camera is `T_wc`; chaining:
T_w_curr = T_w_prev @ T_prev_curr.

RANSAC is not a loop: all `iters` minimal 3-point hypotheses are solved by
the quaternion Kabsch, scored over every correspondence and the first best
taken (`fused_ransac.ransac_select`: one K7 launch on the card, the batched
`kabsch_quat` and an (iters, K) residual matrix on the CPU), and the winner
refit on its inliers with two exact Kabsch solves
(`fused_rigid.rigid_refit`: one K5 launch on the card, the SVD route on the
CPU), then polished on the reprojection (`fused_polish.pose_polish`: one K6
launch on the card).  Random draws come from an explicit `torch.Generator` (the JAX package's
`jax.random.categorical` stream cannot be reproduced); tests inject the
sample indices instead.  Nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jetracer_orbslam2_torch.config import TrackingConfig
from jetracer_orbslam2_torch.models.frontend import Features
from jetracer_orbslam2_torch.ops import fused_polish, fused_ransac, fused_rigid
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.ops import match as match_ops
from jetracer_orbslam2_torch.utils.ties import first_argmin

Tensor = torch.Tensor


class RansacResult(NamedTuple):
    T: Tensor            # (4, 4) best rigid transform src -> dst
    inliers: Tensor      # (K,) bool
    num_inliers: Tensor  # () int32
    ok: Tensor           # () bool


class TrackResult(NamedTuple):
    T_wc: Tensor         # (4, 4) world<-camera pose of current frame
    velocity: Tensor     # (4, 4) T_prev_curr relative motion estimate
    num_matches: Tensor  # () int32
    num_inliers: Tensor  # () int32
    tracked_ok: Tensor   # () bool
    match_idx: Tensor    # (K,) int32 prev->curr match index
    inlier_mask: Tensor  # (K,) bool inliers among prev keypoints


def refine_pose_reprojection(
    T0: Tensor, X_src: Tensor, uv_dst: Tensor, z_dst: Tensor, w: Tensor,
    intrinsics: Tensor, iters: int = 5, huber_px: float = 2.0,
) -> Tensor:
    """Motion-only Gauss-Newton: refine T (dst <- src) so that the known 3D
    points X_src project onto their measured pixels uv_dst (plus a depth
    row anchoring scale where z_dst > 0), with IRLS Huber weights.  One K6
    launch on the card (`fused_polish.pose_polish`), the plain version on
    the CPU."""
    return fused_polish.pose_polish(T0, X_src, uv_dst, z_dst, w, intrinsics,
                                    iters, huber_px)


def ransac_kabsch(
    src: Tensor,
    dst: Tensor,
    weights: Tensor,
    generator: torch.Generator | None = None,
    iters: int = 256,
    thresh: float = 0.05,
    min_inliers: int = 8,
    depth_quad: float = 0.0,
    gate_cap: float = 1e9,
    sample_idx: Tensor | None = None,
) -> RansacResult:
    """Robust rigid fit T with dst ~= T @ src.

    src, dst: (K, 3); weights: (K,) float32 in {0,1} (match validity).
    depth_quad widens the inlier gate per correspondence to
    thresh + depth_quad * z_dst^2 (quadratic range-error model), capped at
    gate_cap.  `sample_idx` (iters, 3), when given, replaces the random
    draw (tests hand both implementations the same samples).
    """
    if sample_idx is None:
        # the clamp mirrors log(max(w, 1e-20)) in the JAX package: with no
        # candidate at all the draw is uniform instead of an error
        probs = weights.clamp_min(1e-20).expand(iters, -1)
        sample_idx = torch.multinomial(probs, 3, replacement=True,
                                       generator=generator)
    sample_idx = sample_idx.long()
    tz = torch.clamp_max(thresh + depth_quad * dst[:, 2] ** 2, gate_cap)  # (K,)
    keep = (weights > 0).to(src.dtype)
    # the iters hypotheses, their scores over all correspondences, the first
    # best and its inliers: one K7 launch on the card
    _, _, w1 = fused_ransac.ransac_select(src, dst, keep, sample_idx, tz)
    # refine on the best hypothesis' inliers, recompute the inliers at that
    # fit and refine once more: one K5 launch on the card
    T2, w2, n = fused_rigid.rigid_refit(src, dst, w1, keep, tz)
    inl1 = w2 > 0
    ok = n >= min_inliers
    eye = torch.eye(4, dtype=src.dtype, device=src.device)
    return RansacResult(T=torch.where(ok, T2, eye), inliers=inl1,
                        num_inliers=n, ok=ok)


@torch.no_grad()
def track_rgbd(
    prev: Features,
    curr: Features,
    T_w_prev: Tensor,
    velocity: Tensor,
    intrinsics: Tensor,
    generator: torch.Generator | None = None,
    cfg: TrackingConfig = TrackingConfig(),
    sample_idx: Tensor | None = None,
) -> TrackResult:
    """One tracking step between consecutive RGB-D frames.

    velocity: previous relative motion T_prevprev_prev, reused as the
    constant-velocity prediction T_prev_curr.
    """
    # Predict current positions of prev keypoints for the match gate:
    # X_curr_pred = inv(velocity) @ X_prev  (velocity = T_prev_curr)
    rel_pred_inv = geo.pose_inverse(velocity)
    pts_in_curr = geo.transform_points(rel_pred_inv, prev.points[None])[0]
    xy_pred = geo.project(pts_in_curr, intrinsics)

    m = match_ops.match(
        prev.desc,
        curr.desc,
        prev.has_point,
        curr.has_point,
        xy_a_pred=xy_pred,
        xy_b=curr.xy,
        window=cfg.match_window,
        max_hamming=cfg.match_max_hamming,
        ratio=cfg.match_ratio,
    )
    idx = m.idx.long()
    dst_pts = curr.points[idx]
    pair_ok = m.valid & curr.has_point[idx]
    num_matches = torch.sum(pair_ok).to(torch.int32)

    # Solve T_prev_curr directly: X_prev = T @ X_curr
    rr = ransac_kabsch(
        dst_pts,
        prev.points,
        pair_ok.to(torch.float32),
        generator,
        iters=cfg.ransac_iters,
        thresh=cfg.ransac_inlier_thresh,
        min_inliers=cfg.min_inliers,
        depth_quad=cfg.ransac_depth_quad,
        sample_idx=sample_idx,
    )
    ok = rr.ok & (num_matches >= cfg.min_matches)
    # motion-only reprojection polish on the consensus set: pixel
    # measurements are unbiased at +-0.5 px while 3D depth noise grows as
    # z^2, so the final pose minimizes reprojection (+ depth anchor) over
    # the RANSAC inliers rather than 3D-3D Kabsch alone
    inlier_mask = rr.inliers & pair_ok
    w_in = inlier_mask.to(torch.float32)
    z_prev = torch.where(prev.has_point, prev.points[:, 2],
                         torch.zeros_like(prev.points[:, 2]))
    T_ref = refine_pose_reprojection(
        rr.T, dst_pts, prev.xy, z_prev, w_in, intrinsics)
    T_prev_curr = torch.where(ok, T_ref, velocity)  # fall back to motion model
    T_w_curr = T_w_prev @ T_prev_curr
    return TrackResult(
        T_wc=T_w_curr,
        velocity=T_prev_curr,
        num_matches=num_matches,
        num_inliers=rr.num_inliers,
        tracked_ok=ok,
        match_idx=m.idx,
        inlier_mask=inlier_mask,
    )


_BIG = 1e9


def icp(
    src: Tensor,
    dst: Tensor,
    src_mask: Tensor,
    dst_mask: Tensor,
    iters: int = 8,
    max_pair_dist: float = 0.25,
    T_init: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Point-to-point ICP (reference buildStream.cpp:134-188).

    Returns (T, mean_err) with dst ~= T @ src.  A fixed number of
    iterations, each a masked (Ns, Nd) distance matrix, the first nearest
    neighbour (`first_argmin`, the JAX tie order) and a weighted `kabsch`
    refit.  The loop reads nothing back to the host: on a CUDA device the
    refit is the K5 kernel, which makes the host wait for nothing.
    """
    T = (torch.eye(4, dtype=src.dtype, device=src.device) if T_init is None
         else T_init)
    err = src.new_zeros(())
    for _ in range(iters):
        src_t = geo.transform_points(T, src[None])[0]
        d2 = torch.sum((src_t[:, None] - dst[None]) ** 2, -1)
        d2 = torch.where(dst_mask[None, :], d2, _BIG)
        d2_min, nn = first_argmin(d2, dim=1)
        nn_dist = torch.sqrt(d2_min)
        w = (src_mask & (nn_dist < max_pair_dist)).to(src.dtype)
        T = geo.kabsch(src, dst.index_select(0, nn), w)
        err = torch.sum(nn_dist * w) / torch.clamp_min(torch.sum(w), 1.0)
    return T, err
