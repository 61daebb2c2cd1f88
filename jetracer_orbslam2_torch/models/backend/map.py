"""Fixed-capacity keyframe/landmark map store.

Counterpart of `jetracer_orbslam2_tpu/models/backend/map.py`: preallocated
device tensors with validity masks and monotonic counters; inserts write
fixed-size blocks; queries are dense batched ops.  No host-side per-landmark
bookkeeping: the map IS a tuple of tensors.  Every function returns a new
`MapState` and leaves its argument untouched, and none reads a value back to
the host (the counters are 0-dim tensors).

Ported here: `init_map`, `global_descriptor`, `insert_keyframe`,
`compact_map`, `compact_keyframes`, `resolve_kf_poses`,
`associate_landmarks`.

Where the JAX package ranks a boolean mask with a stable argsort, the port
takes a cumulative sum: the same rank, no sort and no tie question.  Where
it scatters with clamped targets, the port sends every masked-out write to
one spare row that is sliced off, so each kept slot is written exactly once
and the result cannot depend on the order of the writes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jetracer_orbslam2_torch.config import MapConfig
from jetracer_orbslam2_torch.models.frontend import Features
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.utils.device import resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32

Tensor = torch.Tensor


class MapState(NamedTuple):
    # keyframes
    kf_pose: Tensor      # (Kf, 4, 4) T_wc
    kf_valid: Tensor     # (Kf,) bool
    kf_frame_id: Tensor  # (Kf,) int32 source frame index
    # per-keyframe raw features (for loop-closure retrieval + relocalization)
    kf_desc: Tensor      # (Kf, K, 8) int32 (uint32 bit pattern)
    kf_xy: Tensor        # (Kf, K, 2) float32
    kf_points: Tensor    # (Kf, K, 3) float32 camera-frame 3D
    kf_has_point: Tensor  # (Kf, K) bool
    kf_global_desc: Tensor  # (Kf, 256) float32 mean-bit global descriptor
    # landmarks
    lm_pos: Tensor       # (L, 3) world positions
    lm_desc: Tensor      # (L, 8) int32 representative descriptor
    lm_valid: Tensor     # (L,) bool
    lm_ref_kf: Tensor    # (L,) int32 keyframe slot that spawned the landmark
    # observations (flat edge list)
    obs_kf: Tensor       # (O,) int32 keyframe slot
    obs_lm: Tensor       # (O,) int32 landmark slot
    obs_uv: Tensor       # (O, 2) float32 pixel measurement
    obs_z: Tensor        # (O,) float32 measured camera-frame depth (0 = none)
    obs_valid: Tensor    # (O,) bool
    # retained loop-closure constraints: every accepted loop edge persists
    # so each pose-graph solve re-applies all of them
    loop_i: Tensor       # (Le,) int32 query keyframe slot
    loop_j: Tensor       # (Le,) int32 matched keyframe slot
    loop_T: Tensor       # (Le, 4, 4) verified relative pose T_ij
    loop_valid: Tensor   # (Le,) bool
    # retired-keyframe ring: culled keyframes leave behind (uid, anchor uid,
    # pose relative to the anchor at cull time)
    dead_uid: Tensor         # (D,) int32 frame_id of the culled keyframe
    dead_anchor_uid: Tensor  # (D,) int32 frame_id of its surviving anchor
    dead_rel: Tensor         # (D, 4, 4) inv(anchor_pose) @ culled_pose
    dead_seq: Tensor         # (D,) int32 monotonic cull sequence number
    dead_valid: Tensor       # (D,) bool
    # counters
    num_kf: Tensor       # () int32
    num_lm: Tensor       # () int32
    num_obs: Tensor      # () int32
    num_loop: Tensor     # () int32
    num_dead: Tensor     # () int32 total keyframes ever culled (ring head)


def init_map(cfg: MapConfig, num_keypoints: int, desc_words: int = 8,
             device=None) -> MapState:
    """An empty map on `device` (None = cuda:0, raises without a CUDA
    device; "cpu" on request)."""
    dev = resolve_device(device)
    kf, lm, ob, k = (cfg.max_keyframes, cfg.max_landmarks, cfg.max_obs,
                     num_keypoints)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def eyes(count):
        return torch.eye(4, dtype=torch.float32, device=dev).repeat(count, 1, 1)

    f32, i32, b = torch.float32, torch.int32, torch.bool
    return MapState(
        kf_pose=eyes(kf),
        kf_valid=zeros(kf, b),
        kf_frame_id=zeros(kf, i32),
        kf_desc=zeros((kf, k, desc_words), i32),
        kf_xy=zeros((kf, k, 2), f32),
        kf_points=zeros((kf, k, 3), f32),
        kf_has_point=zeros((kf, k), b),
        kf_global_desc=zeros((kf, 256), f32),
        lm_pos=zeros((lm, 3), f32),
        lm_desc=zeros((lm, desc_words), i32),
        lm_valid=zeros(lm, b),
        lm_ref_kf=zeros(lm, i32),
        obs_kf=zeros(ob, i32),
        obs_lm=zeros(ob, i32),
        obs_uv=zeros((ob, 2), f32),
        obs_z=zeros(ob, f32),
        obs_valid=zeros(ob, b),
        loop_i=zeros(cfg.max_loop_edges, i32),
        loop_j=zeros(cfg.max_loop_edges, i32),
        loop_T=eyes(cfg.max_loop_edges),
        loop_valid=zeros(cfg.max_loop_edges, b),
        dead_uid=zeros(cfg.max_dead_keyframes, i32),
        dead_anchor_uid=zeros(cfg.max_dead_keyframes, i32),
        dead_rel=eyes(cfg.max_dead_keyframes),
        dead_seq=torch.full((cfg.max_dead_keyframes,), -1, dtype=i32,
                            device=dev),
        dead_valid=zeros(cfg.max_dead_keyframes, b),
        num_kf=zeros((), i32),
        num_lm=zeros((), i32),
        num_obs=zeros((), i32),
        num_loop=zeros((), i32),
        num_dead=zeros((), i32),
    )


def _map_to(m: MapState, dev: torch.device) -> MapState:
    return MapState(*(f.to(dev) for f in m))


def _features_to(feats: Features, dev: torch.device) -> Features:
    return Features(*(f.to(dev) for f in feats))


def global_descriptor(desc: Tensor, valid: Tensor) -> Tensor:
    """(K, 8) packed -> (256,) mean bit vector over valid keypoints (a
    cheap whole-image retrieval signature)."""
    from jetracer_orbslam2_torch.ops.orb import unpack_bits

    bits = unpack_bits(desc)  # (K, 256)
    w = valid.to(torch.float32)[:, None]
    return torch.sum(bits * w, 0) / torch.sum(w).clamp_min(1.0)


def _rank_selected_first(mask: Tensor) -> Tensor:
    """Position of every element when the True ones are packed first, each
    group keeping its order: what `argsort(argsort(~mask, stable))` gives,
    from two cumulative sums."""
    m = mask.to(torch.int64)
    n_true = m.sum()
    return torch.where(mask, torch.cumsum(m, 0) - 1,
                       n_true + torch.cumsum(1 - m, 0) - 1)


def _order_selected_first(mask: Tensor) -> Tensor:
    """The permutation that packs the True elements first, stably: what
    `argsort(~mask, stable=True)` gives.  The ranks are unique, so the
    scatter that inverts them is deterministic."""
    rank = _rank_selected_first(mask)
    return torch.empty_like(rank).scatter_(
        0, rank, torch.arange(mask.shape[0], device=mask.device))


def _write_rows(arr: Tensor, slot: Tensor, ok: Tensor, values: Tensor) -> Tensor:
    """A copy of `arr` with row slot[k] replaced by values[k] wherever ok[k].
    The slots of the kept writes are distinct; every other write lands on a
    spare row that is sliced off."""
    cap = arr.shape[0]
    out = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    out[torch.where(ok, slot, cap)] = values.to(arr.dtype)
    return out[:cap]


def insert_keyframe(
    m: MapState,
    feats: Features,
    T_wc: Tensor,
    frame_id,
    new_lm_mask: Tensor,
    lm_match_idx: Tensor,
    lm_match_ok: Tensor,
    device=None,
) -> tuple[MapState, Tensor]:
    """Insert a keyframe; create landmarks for `new_lm_mask` keypoints and
    observations for both new and matched (`lm_match_ok`) landmarks.

    new_lm_mask: (K,) bool, keypoints that should spawn new landmarks
      (has_point and not associated to an existing landmark).
    lm_match_idx/ok: (K,) association of keypoints to EXISTING landmark slots.

    Returns (new_map, kf_slot).  Fixed shapes throughout: each insert
    considers exactly K landmark slots and K observation slots.  Capacity
    overflow drops the overflowing entries (mask stays False).
    """
    dev = resolve_device(device)
    set_exact_f32()
    m, feats = _map_to(m, dev), _features_to(feats, dev)
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32).to(dev)
    frame_id = torch.as_tensor(frame_id).to(dev).to(torch.int32)
    new_lm_mask = torch.as_tensor(new_lm_mask).to(dev)
    lm_match_idx = torch.as_tensor(lm_match_idx).to(dev)
    lm_match_ok = torch.as_tensor(lm_match_ok).to(dev)

    slot = m.num_kf
    kf_cap = m.kf_valid.shape[0]
    lm_cap = m.lm_valid.shape[0]
    obs_cap = m.obs_valid.shape[0]
    can_insert = slot < kf_cap
    slot_c = slot.clamp(max=kf_cap - 1)

    new_lm_mask = new_lm_mask & feats.has_point & can_insert

    # --- landmarks: compact new ones to the tail [num_lm, num_lm + n_new)
    lm_slot = m.num_lm + _rank_selected_first(new_lm_mask)   # slot per keypoint
    lm_ok = new_lm_mask & (lm_slot < lm_cap)
    world_pts = geo.transform_points(T_wc, feats.points[None])[0]
    lm_pos = _write_rows(m.lm_pos, lm_slot, lm_ok, world_pts)
    lm_desc = _write_rows(m.lm_desc, lm_slot, lm_ok, feats.desc)
    lm_valid = _write_rows(m.lm_valid, lm_slot, lm_ok, lm_ok)
    lm_ref_kf = _write_rows(m.lm_ref_kf, lm_slot, lm_ok,
                            slot_c.expand(lm_ok.shape[0]))
    n_new = torch.sum(lm_ok).to(torch.int32)

    # --- observations: one per keypoint that references a landmark
    # (either the newly created one or the matched existing one)
    obs_target = torch.where(lm_ok, lm_slot.clamp(max=lm_cap - 1),
                             lm_match_idx.to(torch.int64))
    obs_ok = lm_ok | (lm_match_ok & feats.valid & can_insert)
    obs_slot = m.num_obs + _rank_selected_first(obs_ok)
    obs_ok = obs_ok & (obs_slot < obs_cap)
    z_meas = torch.where(feats.has_point, feats.points[:, 2],
                         torch.zeros_like(feats.points[:, 2]))
    obs_kf = _write_rows(m.obs_kf, obs_slot, obs_ok,
                         slot_c.expand(obs_ok.shape[0]))
    obs_lm = _write_rows(m.obs_lm, obs_slot, obs_ok, obs_target)
    obs_uv = _write_rows(m.obs_uv, obs_slot, obs_ok, feats.xy)
    obs_z = _write_rows(m.obs_z, obs_slot, obs_ok, z_meas)
    obs_valid = _write_rows(m.obs_valid, obs_slot, obs_ok, obs_ok)
    n_obs = torch.sum(obs_ok).to(torch.int32)

    gdesc = global_descriptor(feats.desc, feats.valid)

    at = slot_c.reshape(1).to(torch.int64)

    def upd(arr, val):
        # row slot_c <- val when can_insert, else the row it already holds;
        # index_copy takes the slot as a tensor, so the host does not wait
        val = torch.as_tensor(val, dtype=arr.dtype, device=dev)
        row = torch.where(can_insert, val, arr.index_select(0, at)[0])
        return arr.index_copy(0, at, row[None])

    m2 = m._replace(
        kf_pose=upd(m.kf_pose, T_wc),
        kf_valid=upd(m.kf_valid, torch.ones((), dtype=torch.bool, device=dev)),
        kf_frame_id=upd(m.kf_frame_id, frame_id),
        kf_desc=upd(m.kf_desc, feats.desc),
        kf_xy=upd(m.kf_xy, feats.xy),
        kf_points=upd(m.kf_points, feats.points),
        kf_has_point=upd(m.kf_has_point, feats.has_point),
        kf_global_desc=upd(m.kf_global_desc, gdesc),
        lm_pos=lm_pos,
        lm_desc=lm_desc,
        lm_valid=lm_valid,
        lm_ref_kf=lm_ref_kf,
        obs_kf=obs_kf,
        obs_lm=obs_lm,
        obs_uv=obs_uv,
        obs_z=obs_z,
        obs_valid=obs_valid,
        num_kf=torch.where(can_insert, slot + 1, slot).to(torch.int32),
        num_lm=(m.num_lm + n_new).to(torch.int32),
        num_obs=(m.num_obs + n_obs).to(torch.int32),
    )
    return m2, slot_c


def compact_map(m: MapState, min_obs, min_age_kf, device=None) -> MapState:
    """Landmark culling + observation recycling (fixed shapes).

    Culls landmarks that are old enough (created >= min_age_kf keyframes
    ago) yet still weakly observed (< min_obs observations), then compacts
    both the landmark table and the observation edge list so freed slots
    are reusable by insert_keyframe (which allocates from num_lm / num_obs
    upward).  Without this, a long run saturates max_obs and mapping
    silently stops.
    """
    dev = resolve_device(device)
    m = _map_to(m, dev)
    newest = m.num_kf - 1
    L = m.lm_valid.shape[0]
    obs_lm_i = m.obs_lm.to(torch.int64)

    nobs = _segment_count(obs_lm_i, m.obs_valid.to(torch.float32), L)
    age = newest - m.lm_ref_kf
    cull = m.lm_valid & (nobs < min_obs) & (age >= min_age_kf)
    lm_keep = m.lm_valid & ~cull

    # --- landmark compaction: kept landmarks pack to the front ---
    order = _order_selected_first(lm_keep)              # kept first
    new_idx = torch.cumsum(lm_keep.to(torch.int32), 0) - 1   # old -> new slot
    lm_valid = lm_keep[order]
    num_lm = torch.sum(lm_keep).to(torch.int32)

    # --- observation compaction: drop edges of culled landmarks, remap ---
    obs_keep = (m.obs_valid & lm_keep[obs_lm_i]
                & m.kf_valid[m.obs_kf.to(torch.int64)])
    obs_lm_new = new_idx[obs_lm_i].to(torch.int32)
    oorder = _order_selected_first(obs_keep)
    obs_valid = obs_keep[oorder]
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)

    return m._replace(
        lm_pos=m.lm_pos[order], lm_desc=m.lm_desc[order],
        lm_ref_kf=m.lm_ref_kf[order],
        lm_valid=lm_valid, num_lm=num_lm,
        obs_kf=torch.where(obs_valid, m.obs_kf[oorder], zero_i),
        obs_lm=torch.where(obs_valid, obs_lm_new[oorder], zero_i),
        obs_uv=torch.where(obs_valid[:, None], m.obs_uv[oorder], zero_f),
        obs_z=torch.where(obs_valid, m.obs_z[oorder], zero_f),
        obs_valid=obs_valid,
        num_obs=torch.sum(obs_keep).to(torch.int32),
    )


def _segment_count(index: Tensor, ones: Tensor, size: int) -> Tensor:
    """Sum the 0/1 values `ones` into `size` segments.  The sums are small
    whole numbers, exact in their type whatever order `index_add_` takes."""
    return torch.zeros(size, dtype=ones.dtype, device=ones.device).index_add_(
        0, index, ones)


def compact_keyframes(
    m: MapState,
    redundancy,           # f32: cull when >= this fraction of the KF's
    #                       observations see well-covered landmarks
    min_covisible,        # i32: "well-covered" = seen by >= this many
    #                       OTHER keyframes
    protect_recent,       # i32: newest slots never culled (BA window)
    target_kf,            # i32: force-cull down to this count if above
    protect_loop_recent=8,  # i32: endpoints of only the newest N loop edges
    #                         are protected
    device=None,
) -> MapState:
    """Redundant-keyframe culling + keyframe slot recycling.

    The ORB-SLAM2 redundant-KF rule (a keyframe most of whose landmarks
    are observed by >= 3 other keyframes adds no information) on the
    fixed-capacity store: scores and the cull set come from segment sums,
    survivors stable-pack to the front (slot order remains temporal order,
    which the BA window and the pose-graph chain rely on), and every slot
    reference (obs_kf, lm_ref_kf, loop_i/j) is remapped through one cumsum.
    Under capacity pressure (num_kf > target_kf) the most redundant eligible
    keyframes are culled regardless of the threshold.

    Culled keyframes push (uid, anchor uid, relative pose) into the retired
    ring so trajectory composition stays exact (see `resolve_kf_poses`).
    Slot 0 (gauge), the newest `protect_recent` slots and the endpoints of
    the newest loop edges are never culled.  Landmarks of a culled keyframe
    re-anchor (lm_ref_kf) to the nearest surviving earlier keyframe; its
    observations drop and the observation list is stable-packed here, so
    num_obs stays the exact allocation head and the valid prefix of obs_kf
    stays sorted after a bare call.  An older loop edge whose endpoint is
    culled retires onto the endpoint's anchor, its measurement composed with
    the culled->anchor offset; an edge whose endpoints collapse onto one
    anchor is dropped.
    """
    dev = resolve_device(device)
    set_exact_f32()
    m = _map_to(m, dev)
    Kf = m.kf_valid.shape[0]
    L = m.lm_valid.shape[0]
    D = m.dead_valid.shape[0]
    Le = m.loop_valid.shape[0]
    i32, f32 = torch.int32, torch.float32
    slots = torch.arange(Kf, device=dev)
    obs_lm_i, obs_kf_i = m.obs_lm.to(torch.int64), m.obs_kf.to(torch.int64)
    loop_i, loop_j = m.loop_i.to(torch.int64), m.loop_j.to(torch.int64)

    # redundancy score per keyframe
    seen = m.obs_valid.to(f32)
    nobs = _segment_count(obs_lm_i, seen, L)
    # a host number stays on the host: no upload, so a captured step may call this
    covisible = (min_covisible.to(dev).to(f32) if isinstance(min_covisible, Tensor)
                 else float(min_covisible))
    well = nobs[obs_lm_i] >= covisible + 1.0
    kf_tot = _segment_count(obs_kf_i, seen, Kf)
    kf_well = _segment_count(obs_kf_i, (m.obs_valid & well).to(f32), Kf)
    # a keyframe with no live observation carries no map information: fully
    # redundant, so that it stays cullable
    red = torch.where(kf_tot > 0.0, kf_well / kf_tot.clamp_min(1.0),
                      torch.ones_like(kf_tot))

    # ring slot r holds the loop edge of age (num_loop - 1 - r) mod Le
    edge_age = torch.remainder(
        m.num_loop - 1 - torch.arange(Le, device=dev), Le)
    edge_protected = (m.loop_valid & (edge_age < protect_loop_recent)).to(i32)
    in_loop = (_segment_count(loop_i, edge_protected, Kf)
               + _segment_count(loop_j, edge_protected, Kf)) > 0
    protected = ((slots == 0) | (slots >= m.num_kf - protect_recent)
                 | in_loop | ~m.kf_valid)
    eligible = ~protected
    cull = eligible & (red >= redundancy)
    # capacity pressure: force the most redundant out until target_kf fits
    n_force = (m.num_kf - target_kf).clamp_min(0)
    score = torch.where(eligible, red, torch.full_like(red, float("-inf")))
    by_score = torch.argsort(-score, stable=True)   # ties in slot order
    rank = torch.empty_like(by_score).scatter_(0, by_score, slots)
    cull = cull | (eligible & (rank < n_force))     # rank 0 = most redundant
    keep = m.kf_valid & ~cull

    order = _order_selected_first(keep)             # kept first, slot order
    # new index of the nearest kept slot at-or-before each old slot (a kept
    # slot: its own new index; a culled one: its anchor's)
    before_idx = (torch.cumsum(keep.to(torch.int64), 0) - 1).clamp_min(0)
    anchor_old = order[before_idx]                  # old slot of that anchor

    # retired ring push: one row per culled keyframe
    seq = m.num_dead + torch.cumsum(cull.to(torch.int64), 0) - 1
    pos = torch.remainder(seq, D)
    rel = geo.pose_inverse(m.kf_pose[anchor_old]) @ m.kf_pose
    dead = dict(
        dead_uid=_write_rows(m.dead_uid, pos, cull, m.kf_frame_id),
        dead_anchor_uid=_write_rows(m.dead_anchor_uid, pos, cull,
                                    m.kf_frame_id[anchor_old]),
        dead_rel=_write_rows(m.dead_rel, pos, cull, rel),
        dead_seq=_write_rows(m.dead_seq, pos, cull, seq),
        dead_valid=_write_rows(m.dead_valid, pos, cull, cull),
        num_dead=(m.num_dead + torch.sum(cull)).to(i32),
    )

    obs_keep = m.obs_valid & keep[obs_kf_i]
    obs_kf_new = before_idx[obs_kf_i].to(i32)
    oorder = _order_selected_first(obs_keep)
    obs_valid = obs_keep[oorder]
    zero_i = torch.zeros((), dtype=i32, device=dev)
    zero_f = torch.zeros((), dtype=f32, device=dev)

    # an edge (i, j, T_ij) whose endpoint i was culled becomes (anchor_i, j)
    # with measurement rel_i @ T_ij @ rel_j^-1 (rel_k = inv(T_anchor) T_k at
    # cull time, identity for kept endpoints)
    loop_T = rel[loop_i] @ (m.loop_T @ geo.pose_inverse(rel[loop_j]))
    new_li = before_idx[loop_i].to(i32)
    new_lj = before_idx[loop_j].to(i32)
    loop_valid = m.loop_valid & (new_li != new_lj)
    return m._replace(
        kf_pose=m.kf_pose[order],
        kf_valid=keep[order],
        kf_frame_id=m.kf_frame_id[order],
        kf_desc=m.kf_desc[order],
        kf_xy=m.kf_xy[order],
        kf_points=m.kf_points[order],
        kf_has_point=m.kf_has_point[order],
        kf_global_desc=m.kf_global_desc[order],
        lm_ref_kf=torch.where(
            m.lm_valid, before_idx[m.lm_ref_kf.to(torch.int64)].to(i32), zero_i),
        obs_kf=torch.where(obs_valid, obs_kf_new[oorder], zero_i),
        obs_lm=torch.where(obs_valid, m.obs_lm[oorder], zero_i),
        obs_uv=torch.where(obs_valid[:, None], m.obs_uv[oorder], zero_f),
        obs_z=torch.where(obs_valid, m.obs_z[oorder], zero_f),
        obs_valid=obs_valid,
        num_obs=torch.sum(obs_keep).to(i32),
        loop_i=torch.where(loop_valid, new_li, zero_i),
        loop_j=torch.where(loop_valid, new_lj, zero_i),
        loop_T=torch.where(loop_valid[:, None, None], loop_T, m.loop_T),
        loop_valid=loop_valid,
        num_kf=torch.sum(keep).to(i32),
        **dead,
    )


def resolve_kf_poses(m: MapState) -> dict:
    """uid (keyframe frame_id) -> final optimized world pose, for live AND
    retired keyframes (on the host, at result time only).

    Retired entries resolve newest-cull-first: each anchor was alive at cull
    time, so it is either still live or was retired later (= already
    resolved).  Entries overwritten by ring wrap-around are simply absent:
    callers fall back to the pose recorded at frame emission."""
    import numpy as np

    kf_valid = m.kf_valid.cpu().numpy()
    kf_uid = m.kf_frame_id.cpu().numpy()
    kf_pose = m.kf_pose.cpu().numpy()
    table = {int(u): kf_pose[i]
             for i, u in enumerate(kf_uid) if kf_valid[i]}
    dv = np.flatnonzero(m.dead_valid.cpu().numpy())
    if dv.size:
        seq = m.dead_seq.cpu().numpy()[dv]
        uid = m.dead_uid.cpu().numpy()[dv]
        anc = m.dead_anchor_uid.cpu().numpy()[dv]
        rel = m.dead_rel.cpu().numpy()[dv]
        for j in np.argsort(-seq, kind="stable"):
            u, a = int(uid[j]), int(anc[j])
            if u not in table and a in table:
                table[u] = table[a] @ rel[j]
    return table


def associate_landmarks(
    m: MapState,
    feats: Features,
    T_wc_pred: Tensor,
    intrinsics: Tensor,
    max_hamming: float = 64.0,
    window: float = 24.0,
    device=None,
) -> tuple[Tensor, Tensor]:
    """Match frame keypoints to map landmarks by projecting landmarks into
    the predicted view and Hamming-matching within a window.

    Returns (lm_idx (K,) int32, ok (K,) bool).
    """
    from jetracer_orbslam2_torch.ops import match as match_ops

    dev = resolve_device(device)
    set_exact_f32()
    m, feats = _map_to(m, dev), _features_to(feats, dev)
    T_wc_pred = torch.as_tensor(T_wc_pred, dtype=torch.float32).to(dev)
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32).to(dev)

    T_cw = geo.pose_inverse(T_wc_pred)
    pts_c = geo.transform_points(T_cw, m.lm_pos[None])[0]
    uv = geo.project(pts_c, intrinsics)
    in_front = pts_c[:, 2] > 0.05
    res = match_ops.match(
        feats.desc, m.lm_desc,
        feats.valid, m.lm_valid & in_front,
        xy_a_pred=feats.xy, xy_b=uv,
        window=window, max_hamming=max_hamming, mutual=True,
    )
    return res.idx, res.valid
