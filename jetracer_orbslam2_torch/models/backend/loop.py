"""Loop closure: retrieval -> geometric verification -> pose-graph correction.

Counterpart of `jetracer_orbslam2_tpu/models/backend/loop.py`.  Pipeline:

  1. `retrieve*`: centred-cosine scores between the query keyframe's global
     descriptor (mean BRIEF bit vector, `map.global_descriptor`) and all
     stored keyframes: a (Kf, 256) x (256,) product.
  2. `verify*`: full K x K Hamming matching between the two keyframes'
     descriptors (`ops/match.py`, as the tracker) and RANSAC-Kabsch on their
     camera-frame 3D points -> relative pose T_ab.
  3. `close`: a pose graph over keyframes (odometry chain edges + every
     retained loop edge), optimized (`backend/pose_graph.py`), then each
     landmark rigidly carried with its reference keyframe's correction.

Nothing here reads a value back to the host.  RANSAC samples come from
uniforms the caller drew ahead (the SLAM frame draws them whether or not its
branches run), else from the caller's `torch.Generator`; tests inject the
sample indices instead.  The shortlist's candidates are verified as one
batch, the JAX package's `vmap`: one K7 and one K5 launch on the card.  Where the JAX package leans
on a tie order (`argmax`, `lax.top_k`), the port computes it: the first index
for an arg-reduction, a stable descending sort for the shortlist.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from jetracer_orbslam2_torch.config import LoopClosureConfig, PoseGraphConfig
from jetracer_orbslam2_torch.models import tracking
from jetracer_orbslam2_torch.models.backend.map import MapState, _map_to
from jetracer_orbslam2_torch.models.backend.pose_graph import (
    PoseGraphProblem, optimize_pose_graph)
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.ops import match as match_ops
from jetracer_orbslam2_torch.utils.device import resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32
from jetracer_orbslam2_torch.utils.ties import first_argmax

Tensor = torch.Tensor

VERIFY_RANSAC_ITERS = 512
NO_CANDIDATE_UID = -1_000_000


class LoopCandidate(NamedTuple):
    kf_idx: Tensor    # () int32 best matching keyframe slot ((topn,) for topn)
    score: Tensor     # () float32 retrieval similarity
    ok: Tensor        # () bool passes gap + similarity gates


class LoopResult(NamedTuple):
    T_ab: Tensor      # (4, 4) verified relative pose: query(a) <- match(b)
    num_inliers: Tensor
    ok: Tensor


def _row(arr: Tensor, idx: Tensor) -> Tensor:
    """arr[idx] for a 0-dim index tensor without reading it back to the host
    (plain indexing with a 0-dim tensor does)."""
    return arr.index_select(0, idx.reshape(1).to(torch.int64))[0]


def _entry(dev, m: MapState, *tensors):
    """Common entry of the public functions: exact f32, the map and every
    tensor argument on the resolved device."""
    set_exact_f32()
    return (_map_to(m, dev),) + tuple(
        torch.as_tensor(x).to(dev) for x in tensors)


def _centered_sims(table: Tensor, q: Tensor) -> Tensor:
    """Centred-cosine similarity of query bit-frequency vector q (256,)
    against each row of table (Kf, 256).

    Global descriptors are mean BRIEF bits: every entry hovers around 0.5,
    so raw cosine between any two frames of the same scene is ~0.97+.
    Subtracting 0.5 turns cosine into a correlation of the bit-frequency
    deviations, which separates true revisits from same-room views."""
    tc = table - 0.5
    qc = q - 0.5
    return tc @ qc / (
        torch.linalg.norm(tc, dim=1) * torch.linalg.norm(qc) + 1e-9)


def _gapped_sims(m: MapState, query_slot: Tensor, min_kf_gap: int) -> tuple[Tensor, Tensor]:
    sims = _centered_sims(m.kf_global_desc, _row(m.kf_global_desc, query_slot))
    slots = torch.arange(m.kf_valid.shape[0], device=sims.device)
    eligible = m.kf_valid & (slots < query_slot - min_kf_gap)
    return sims.masked_fill(~eligible, -1.0), eligible


def _best(sims: Tensor, min_sim, any_eligible: Tensor) -> LoopCandidate:
    score, best = first_argmax(sims, 0)
    return LoopCandidate(kf_idx=best.to(torch.int32), score=score,
                         ok=(score > min_sim) & any_eligible)


@torch.no_grad()
def retrieve(m: MapState, query_slot, min_sim: float, min_kf_gap: int = 10,
             device=None) -> LoopCandidate:
    """Best non-recent keyframe by centred-cosine global-descriptor match."""
    m, query_slot = _entry(resolve_device(device), m, query_slot)
    sims, eligible = _gapped_sims(m, query_slot, min_kf_gap)
    return _best(sims, min_sim, torch.any(eligible))


@torch.no_grad()
def retrieve_global(m: MapState, gdesc: Tensor, min_sim, device=None) -> LoopCandidate:
    """Best keyframe for an arbitrary query global descriptor (no recency
    exclusion): the relocalization entry, where the lost frame is not a
    keyframe and the most recent keyframes are the ones worth re-posing
    against."""
    m, gdesc = _entry(resolve_device(device), m, gdesc)
    sims = _centered_sims(m.kf_global_desc, gdesc).masked_fill(~m.kf_valid, -1.0)
    return _best(sims, min_sim, torch.any(m.kf_valid))


@torch.no_grad()
def retrieve_topn(m: MapState, query_slot, min_sim: float, min_kf_gap: int = 10,
                  topn: int = 3, device=None) -> LoopCandidate:
    """Top-N non-recent keyframes by centred-cosine global-descriptor match
    (under perceptual aliasing the true revisit may rank behind a look-alike,
    so every shortlisted candidate gets geometric verification).  Equal
    scores keep slot order, as `lax.top_k` gives them."""
    m, query_slot = _entry(resolve_device(device), m, query_slot)
    sims, _ = _gapped_sims(m, query_slot, min_kf_gap)
    scores, idxs = torch.sort(sims, descending=True, stable=True)
    scores, idxs = scores[:topn], idxs[:topn]
    return LoopCandidate(kf_idx=idxs.to(torch.int32), score=scores,
                         ok=scores > min_sim)


def _match_weights(desc_a, has_a, desc_b, has_b, pts_b):
    """Mutual descriptor matches of a's keypoints in b: b's point matched to
    each of a's keypoints, and the weight of each pair (a match with valid
    camera-frame 3D)."""
    res = match_ops.match(
        desc_a, desc_b, has_a, has_b,
        xy_a_pred=None, xy_b=None, window=0.0,
        max_hamming=80.0, mutual=True,
    )
    idx = res.idx.long()
    return pts_b[idx], (res.valid & has_b[idx]).to(torch.float32)


def _verify_pair(
    desc_a, has_a, pts_a, desc_b, has_b, pts_b,
    generator: Optional[torch.Generator],
    thresh: float, min_inliers: int, depth_quad: float = 0.0,
    gate_cap: float = 1e9, sample_idx: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> LoopResult:
    """Descriptor-match two feature sets and RANSAC a rigid relative pose:
    points_a ~= T_ab @ points_b over mutually-matched keypoints with valid
    camera-frame 3D.  depth_quad widens the inlier gate quadratically with
    range (`TrackingConfig.ransac_depth_quad`).  b's features may carry a
    leading batch of C candidates (with sample_idx or uniforms (C, 512, 3)):
    the C verifications then run as one RANSAC batch."""
    if desc_b.dim() == 3:
        pairs = [_match_weights(desc_a, has_a, desc_b[c], has_b[c], pts_b[c])
                 for c in range(desc_b.shape[0])]
        pts_b_m = torch.stack([p for p, _ in pairs])
        w = torch.stack([w for _, w in pairs])
        pts_a = pts_a.expand(pts_b_m.shape)
    else:
        pts_b_m, w = _match_weights(desc_a, has_a, desc_b, has_b, pts_b)
    rr = tracking.ransac_kabsch(
        pts_b_m, pts_a, w, generator,
        iters=VERIFY_RANSAC_ITERS, thresh=thresh, min_inliers=min_inliers,
        depth_quad=depth_quad, gate_cap=gate_cap, sample_idx=sample_idx,
        uniforms=uniforms,
    )
    return LoopResult(T_ab=rr.T, num_inliers=rr.num_inliers, ok=rr.ok)


def _kf_features(m: MapState, slot: Tensor):
    return (_row(m.kf_desc, slot), _row(m.kf_has_point, slot),
            _row(m.kf_points, slot))


@torch.no_grad()
def verify(m: MapState, slot_a, slot_b,
           generator: Optional[torch.Generator], cfg: LoopClosureConfig,
           sample_idx: Optional[Tensor] = None, device=None) -> LoopResult:
    """Geometric loop verification between two stored keyframes."""
    m, slot_a, slot_b = _entry(resolve_device(device), m, slot_a, slot_b)
    return _verify_pair(
        *_kf_features(m, slot_a), *_kf_features(m, slot_b), generator,
        cfg.ransac_inlier_thresh, cfg.min_inliers, cfg.ransac_depth_quad,
        sample_idx=sample_idx)


def _verify_world(
    m: MapState, q_desc, q_xy, q_valid, slot_b: Tensor, T_ab: Tensor,
    intrinsics: Tensor, window: float, max_obs: int,
) -> Tensor:
    """World-frame loop check: the candidate keyframe's landmarks at their
    CURRENT (post-BA, post-previous-closures) world positions must reproject
    into the query view under the hypothesized pose and agree with the
    query's descriptors.  Returns the inlier count.

    Gathering the candidate's observations rides on a map invariant: the
    valid prefix of obs_kf is sorted by keyframe slot (`insert_keyframe`
    appends the newest slot; `compact_map` / `compact_keyframes` are stable
    packs and monotone slot remaps), so keyframe b's observations occupy one
    contiguous run.  Two masked sums locate it, and when the run exceeds
    max_obs the cap takes an even subsample across the run."""
    dev = m.obs_kf.device
    is_b = m.obs_valid & (m.obs_kf == slot_b)
    start = torch.sum(m.obs_valid & (m.obs_kf < slot_b))
    count = torch.sum(is_b)
    i = torch.arange(max_obs, device=dev)
    off = torch.where(count > max_obs,
                      torch.div(i * count, max_obs, rounding_mode="floor"), i)
    idx = (start + off).clamp_max(m.obs_lm.shape[0] - 1)
    lm = m.obs_lm[idx].long()
    sel_ok = (i < count) & m.lm_valid[lm]
    # hypothesized query camera: T_w_query = T_w_b @ inv(T_ab)
    T_qw = T_ab @ geo.pose_inverse(_row(m.kf_pose, slot_b))
    pts_q = geo.transform_points(T_qw, m.lm_pos[lm][None])[0]
    uv = geo.project(pts_q, intrinsics)
    res = match_ops.match(
        m.lm_desc[lm], q_desc, sel_ok & (pts_q[:, 2] > 0.05), q_valid,
        xy_a_pred=uv, xy_b=q_xy, window=window,
        max_hamming=80.0, mutual=False)
    return torch.sum(res.valid).to(torch.int32)


@torch.no_grad()
def retrieve_and_verify(
    m: MapState, slot, generator: Optional[torch.Generator],
    cfg: LoopClosureConfig, intrinsics, prev_cand_uid, consistency,
    sample_idx: Optional[Tensor] = None, uniforms: Optional[Tensor] = None,
    device=None,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Aliasing-hardened loop detection; the whole decision stays on the
    device and the caller fetches it with its other per-keyframe numbers.

    Three gates on top of retrieval + RANSAC:
      1. top-N shortlist, every candidate geometrically verified: the
         candidate with the strongest RANSAC consensus wins, not the
         retrieval leader;
      2. temporal consistency: the winning candidate must lie within
         `consistency_window` frames of the previous keyframe's winner for
         `min_consistency` consecutive keyframes (keyed by keyframe uid, so
         slot recycling cannot break it);
      3. world-frame agreement: the winner's landmarks at their current
         positions must reproject into the query (`_verify_world`).

    prev_cand_uid / consistency: the caller-carried gate state.
    sample_idx: optional (topn, 512, 3) RANSAC samples, one set per
    shortlisted candidate; else uniforms (topn, 512, 3) in [0, 1), else
    uniforms drawn here from `generator`.  The topn verifications are one
    RANSAC batch (the JAX package's `vmap`).
    Returns (kf_idx, T_ab (4,4), ok, new_prev_cand_uid, new_consistency).
    """
    dev = resolve_device(device)
    m, slot, intrinsics, prev_cand_uid, consistency = _entry(
        dev, m, slot, intrinsics, prev_cand_uid, consistency)
    cands = retrieve_topn(m, slot, cfg.min_sim, cfg.min_kf_gap, cfg.topn,
                          device=dev)
    query = _kf_features(m, slot)
    if sample_idx is None and uniforms is None:
        uniforms = torch.rand((cfg.topn, VERIFY_RANSAC_ITERS, 3),
                              generator=generator, device=dev)
    shortlist = cands.kf_idx.to(torch.int64)
    ver = _verify_pair(
        *query, m.kf_desc.index_select(0, shortlist),
        m.kf_has_point.index_select(0, shortlist),
        m.kf_points.index_select(0, shortlist), None,
        cfg.ransac_inlier_thresh, cfg.min_inliers, cfg.ransac_depth_quad,
        sample_idx=sample_idx, uniforms=uniforms)
    ver_ok, ver_inl, ver_T = ver.ok, ver.num_inliers, ver.T_ab
    score = torch.where(cands.ok & ver_ok, ver_inl, torch.full_like(ver_inl, -1))
    best_score, best = first_argmax(score, 0)
    cand_idx = _row(cands.kf_idx, best)
    T_ab = _row(ver_T, best)
    geom_ok = best_score > 0

    n_world = _verify_world(
        m, query[0], _row(m.kf_xy, slot), query[1],
        cand_idx, T_ab, intrinsics, cfg.world_window, cfg.world_max_obs)

    # temporal consistency over keyframe uids (the geometric winner when one
    # exists, else the retrieval leader keeps the streak measurable)
    retrieved_any = torch.any(cands.ok)
    track_uid = torch.where(
        geom_ok, _row(m.kf_frame_id, cand_idx),
        _row(m.kf_frame_id, cands.kf_idx[0]))
    near_prev = torch.abs(track_uid - prev_cand_uid) <= cfg.consistency_window
    one = torch.ones_like(consistency)
    consistency = torch.where(
        retrieved_any, torch.where(near_prev, consistency + 1, one),
        torch.zeros_like(consistency)).to(torch.int32)
    prev_cand_uid = torch.where(
        retrieved_any, track_uid,
        torch.full_like(track_uid, NO_CANDIDATE_UID)).to(torch.int32)

    ok = (geom_ok & (n_world >= cfg.world_min_inliers)
          & (consistency >= cfg.min_consistency))
    return cand_idx, T_ab, ok, prev_cand_uid, consistency


@torch.no_grad()
def verify_features(
    m: MapState, desc, has_point, points, slot_b,
    generator: Optional[torch.Generator],
    thresh: float, min_inliers: int, depth_quad: float = 0.0,
    gate_cap: float = 1e9, sample_idx: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None, device=None,
) -> LoopResult:
    """Verify a live frame's features against stored keyframe `slot_b` (the
    relocalization pose solve: T_ab maps keyframe-camera coords to
    query-camera coords, so T_w_query = kf_pose[slot_b] @ inv(T_ab)).
    uniforms: optional (512, 3) in [0, 1), the draw made ahead."""
    m, desc, has_point, points, slot_b = _entry(
        resolve_device(device), m, desc, has_point, points, slot_b)
    return _verify_pair(
        desc, has_point, points, *_kf_features(m, slot_b),
        generator, thresh, min_inliers, depth_quad, gate_cap, sample_idx,
        uniforms)


@torch.no_grad()
def close(m: MapState, slot_a, slot_b, T_ab, pg_cfg: PoseGraphConfig,
          device=None) -> MapState:
    """Apply a verified loop edge: persist it, pose-graph optimize over ALL
    retained loop constraints, carry landmarks.

    Edges: odometry chain (k -> k+1 with the current relative pose as the
    measurement: drift lives in the loop edge discrepancy) + every stored
    loop edge (i, j) with measurement T_ij.  The new edge is stored first
    (fixed-capacity ring: beyond `MapConfig.max_loop_edges` the oldest edge
    is overwritten; old loops' corrections stay baked into the chain).  The
    pose graph sums with one-hot products, so two calls give equal maps.
    """
    dev = resolve_device(device)
    m, slot_a, slot_b, T_ab = _entry(dev, m, slot_a, slot_b, T_ab)
    Kf = m.kf_valid.shape[0]
    Le = m.loop_valid.shape[0]
    poses0 = m.kf_pose

    # persist the new edge: a one-row write at the ring's head
    ring = torch.remainder(m.num_loop, Le).reshape(1).to(torch.int64)

    def put(arr, val):
        return arr.index_copy(0, ring, val.to(arr.dtype)[None])

    m = m._replace(
        loop_i=put(m.loop_i, slot_a),
        loop_j=put(m.loop_j, slot_b),
        loop_T=put(m.loop_T, T_ab.to(torch.float32)),
        loop_valid=put(m.loop_valid, torch.ones((), dtype=torch.bool, device=dev)),
        num_loop=(m.num_loop + 1).to(torch.int32),
    )

    # odometry chain edges (slot k -> k+1), valid where both keyframes exist
    idx = torch.arange(Kf - 1, device=dev, dtype=torch.int32)
    chain_T = geo.pose_inverse(poses0[:-1]) @ poses0[1:]
    chain_w = (m.kf_valid[:-1] & m.kf_valid[1:]).to(torch.float32)
    loop_w = m.loop_valid.to(torch.float32) * pg_cfg.loop_weight

    fixed = torch.arange(Kf, device=dev) == 0
    prob = PoseGraphProblem(
        poses=poses0,
        edge_i=torch.cat([idx, m.loop_i]),
        edge_j=torch.cat([idx + 1, m.loop_j]),
        edge_T=torch.cat([chain_T, m.loop_T]),
        edge_weight=torch.cat([chain_w, loop_w]),
        fixed=fixed)
    new_poses, _ = optimize_pose_graph(prob, pg_cfg, device=dev)
    new_poses = torch.where(m.kf_valid[:, None, None], new_poses, poses0)

    # carry each landmark with its reference keyframe: X' = T_new T_old^-1 X
    corr = new_poses @ geo.pose_inverse(poses0)
    C = corr[m.lm_ref_kf.long()]                              # (L, 4, 4)
    new_lm = (C[:, :3, :3] @ m.lm_pos[:, :, None])[:, :, 0] + C[:, :3, 3]
    new_lm = torch.where(m.lm_valid[:, None], new_lm, m.lm_pos)
    return m._replace(kf_pose=new_poses, lm_pos=new_lm)
