"""Carry feature sets, odometry and SLAM state, BA and pose-graph problems and
the keyframe map between numpy and the port's tuples.

The system has no learned weights; the state two implementations must share
(in tests, or when resuming a run made elsewhere) is a frame's `Features`, the
`OdomState`, a `BAProblem`, a `PoseGraphProblem`, the `MapState`, the
`ImuState`, the scan's `ScanState` and the small per-frame and per-loop
results (`FrameReport`, `LoopCandidate`, `LoopResult`).  This
module takes and returns numpy arrays only: field names and layouts are
those of the port's tuples, field for field those of the JAX package, with
descriptors as `uint32` words on the numpy side and `int32` words of the same
bit pattern on the tensor side.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from jetracer_orbslam2_torch.models.backend.ba import BAProblem
from jetracer_orbslam2_torch.models.backend.loop import LoopCandidate, LoopResult
from jetracer_orbslam2_torch.models.backend.map import MapState
from jetracer_orbslam2_torch.models.backend.pose_graph import PoseGraphProblem
from jetracer_orbslam2_torch.models.frontend import Features
from jetracer_orbslam2_torch.models.imu import ImuState
from jetracer_orbslam2_torch.models.odometry import OdomState, make_generator
from jetracer_orbslam2_torch.models.slam import FrameReport
from jetracer_orbslam2_torch.models.slam_scan import ScanState
from jetracer_orbslam2_torch.utils.device import resolve_device

_FEATURE_DTYPES = {
    "xy": np.float32, "level": np.int32, "score": np.float32,
    "angle": np.float32, "desc": np.uint32, "valid": np.bool_,
    "points": np.float32, "has_point": np.bool_,
}


def desc_from_numpy(desc: np.ndarray, device) -> torch.Tensor:
    """(K, W) uint32 -> int32 tensor with the same bits."""
    words = np.ascontiguousarray(np.asarray(desc, dtype=np.uint32))
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """(K, W) int32 tensor -> uint32 array with the same bits."""
    return np.ascontiguousarray(desc.cpu().numpy()).view(np.uint32)


def features_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> Features:
    """Dict of numpy arrays keyed by `Features` field name -> `Features`."""
    dev = resolve_device(device)
    out = {}
    for name, dtype in _FEATURE_DTYPES.items():
        a = np.asarray(fields[name])
        if name == "desc":
            out[name] = desc_from_numpy(a, dev)
        else:
            out[name] = torch.from_numpy(
                np.ascontiguousarray(a.astype(dtype))).to(dev)
    return Features(**out)


def features_to_numpy(feats: Features) -> dict:
    out = {}
    for name in _FEATURE_DTYPES:
        t = getattr(feats, name)
        out[name] = desc_to_numpy(t) if name == "desc" else t.cpu().numpy()
    return out


def odom_state_from_numpy(T_wc, velocity, prev: Mapping[str, np.ndarray],
                          frame_idx: int = 0, seed: int = 0,
                          device=None) -> OdomState:
    """Rebuild an `OdomState`.  The RANSAC stream is not portable between
    frameworks, so the generator is made afresh from `seed`."""
    dev = resolve_device(device)
    f32 = lambda a: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.float32))).to(dev)
    return OdomState(
        T_wc=f32(T_wc), velocity=f32(velocity),
        prev=features_from_numpy(prev, dev),
        frame_idx=torch.tensor(int(frame_idx), dtype=torch.int32, device=dev),
        generator=make_generator(seed, dev),
    )


def odom_state_to_numpy(state: OdomState) -> dict:
    """All array fields of the state (the generator is left out)."""
    return {
        "T_wc": state.T_wc.cpu().numpy(),
        "velocity": state.velocity.cpu().numpy(),
        "prev": features_to_numpy(state.prev),
        "frame_idx": int(state.frame_idx.cpu()),
    }


_BA_DTYPES = {
    "poses": np.float32, "points": np.float32, "obs_kf": np.int32,
    "obs_lm": np.int32, "obs_uv": np.float32, "obs_z": np.float32,
    "obs_z_valid": np.bool_, "obs_valid": np.bool_, "fixed": np.bool_,
}

_POSE_GRAPH_DTYPES = {
    "poses": np.float32, "edge_i": np.int32, "edge_j": np.int32,
    "edge_T": np.float32, "edge_weight": np.float32, "fixed": np.bool_,
}

_MAP_DTYPES = {
    "kf_pose": np.float32, "kf_valid": np.bool_, "kf_frame_id": np.int32,
    "kf_desc": np.uint32, "kf_xy": np.float32, "kf_points": np.float32,
    "kf_has_point": np.bool_, "kf_global_desc": np.float32,
    "lm_pos": np.float32, "lm_desc": np.uint32, "lm_valid": np.bool_,
    "lm_ref_kf": np.int32,
    "obs_kf": np.int32, "obs_lm": np.int32, "obs_uv": np.float32,
    "obs_z": np.float32, "obs_valid": np.bool_,
    "loop_i": np.int32, "loop_j": np.int32, "loop_T": np.float32,
    "loop_valid": np.bool_,
    "dead_uid": np.int32, "dead_anchor_uid": np.int32,
    "dead_rel": np.float32, "dead_seq": np.int32, "dead_valid": np.bool_,
    "num_kf": np.int32, "num_lm": np.int32, "num_obs": np.int32,
    "num_loop": np.int32, "num_dead": np.int32,
}


def _tuple_from_numpy(cls, dtypes, fields, dev):
    """Build the NamedTuple `cls` from `fields`: a mapping by field name, or
    any object with those attributes (the other package's own tuple)."""
    out = {}
    for name, dtype in dtypes.items():
        a = fields[name] if isinstance(fields, Mapping) else getattr(fields, name)
        a = np.asarray(a)
        # np.asarray(order="C") keeps a 0-dim counter 0-dim
        if dtype is np.uint32:
            words = np.asarray(a.astype(np.uint32), order="C")
            out[name] = torch.from_numpy(words.view(np.int32).copy()).to(dev)
        else:
            out[name] = torch.from_numpy(
                np.asarray(a.astype(dtype), order="C")).to(dev)
    return cls(**out)


def _tuple_to_numpy(dtypes, value) -> dict:
    out = {}
    for name, dtype in dtypes.items():
        a = np.asarray(getattr(value, name).cpu().numpy(), order="C")
        out[name] = a.view(np.uint32) if dtype is np.uint32 else a
    return out


def ba_problem_from_numpy(fields, device=None) -> BAProblem:
    """`BAProblem` from numpy arrays keyed by field name (or from an object
    with those attributes)."""
    return _tuple_from_numpy(BAProblem, _BA_DTYPES, fields,
                             resolve_device(device))


def ba_result_to_numpy(poses: torch.Tensor, points: torch.Tensor, stats) -> dict:
    """What `bundle_adjust` returns, as numpy arrays."""
    return {
        "poses": poses.cpu().numpy(),
        "points": points.cpu().numpy(),
        "cost": stats.cost.cpu().numpy(),
        "num_edges": int(stats.num_edges.cpu()),
    }


def pose_graph_problem_from_numpy(fields, device=None) -> PoseGraphProblem:
    return _tuple_from_numpy(PoseGraphProblem, _POSE_GRAPH_DTYPES, fields,
                             resolve_device(device))


def map_state_from_numpy(fields, device=None) -> MapState:
    """`MapState` from numpy arrays keyed by field name (or from an object
    with those attributes); `uint32` descriptors become `int32` words."""
    return _tuple_from_numpy(MapState, _MAP_DTYPES, fields,
                             resolve_device(device))


def map_state_to_numpy(m: MapState) -> dict:
    """Every field of the map as a numpy array (descriptors as `uint32`)."""
    return _tuple_to_numpy(_MAP_DTYPES, m)


_FRAME_REPORT_DTYPES = {
    "tracked_ok": np.bool_, "num_matches": np.int32, "num_assoc": np.int32,
    "need_kf": np.bool_, "T_wc": np.float32, "packed": np.float32,
}
_LOOP_CANDIDATE_DTYPES = {
    "kf_idx": np.int32, "score": np.float32, "ok": np.bool_}
_LOOP_RESULT_DTYPES = {
    "T_ab": np.float32, "num_inliers": np.int32, "ok": np.bool_}
_SCAN_SCALARS = ("frames_since_kf", "lost_streak", "frame_idx", "ref_slot",
                 "num_loops", "num_relocs", "loop_prev_uid", "loop_consist")


def frame_report_from_numpy(fields, device=None) -> FrameReport:
    return _tuple_from_numpy(FrameReport, _FRAME_REPORT_DTYPES, fields,
                             resolve_device(device))


def frame_report_to_numpy(report: FrameReport) -> dict:
    return _tuple_to_numpy(_FRAME_REPORT_DTYPES, report)


def loop_candidate_from_numpy(fields, device=None) -> LoopCandidate:
    return _tuple_from_numpy(LoopCandidate, _LOOP_CANDIDATE_DTYPES, fields,
                             resolve_device(device))


def loop_candidate_to_numpy(cand: LoopCandidate) -> dict:
    return _tuple_to_numpy(_LOOP_CANDIDATE_DTYPES, cand)


def loop_result_from_numpy(fields, device=None) -> LoopResult:
    return _tuple_from_numpy(LoopResult, _LOOP_RESULT_DTYPES, fields,
                             resolve_device(device))


def loop_result_to_numpy(res: LoopResult) -> dict:
    return _tuple_to_numpy(_LOOP_RESULT_DTYPES, res)


def _field(fields, name):
    return fields[name] if isinstance(fields, Mapping) else getattr(fields, name)


def imu_state_from_numpy(fields) -> ImuState:
    """`ImuState` from a mapping (or an object with those attributes).  The
    filter runs on the host, so the state is numpy on both sides."""
    return ImuState(
        theta=np.asarray(_field(fields, "theta"), np.float32).copy(),
        last_ts=np.float32(_field(fields, "last_ts")),
        initialized=np.bool_(_field(fields, "initialized")))


def imu_state_to_numpy(state: ImuState) -> dict:
    return {"theta": np.asarray(state.theta, np.float32),
            "last_ts": np.float32(state.last_ts),
            "initialized": np.bool_(state.initialized)}


def scan_state_from_numpy(fields, seed: int = 0, device=None) -> ScanState:
    """Rebuild a `ScanState` from numpy fields (`m` and `prev` as mappings or
    as the other package's tuples).  The RANSAC stream is not portable between
    frameworks, so the generator is made afresh from `seed`."""
    dev = resolve_device(device)
    f32 = lambda a: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.float32))).to(dev)
    prev = _field(fields, "prev")
    if not isinstance(prev, Mapping):
        prev = {name: np.asarray(getattr(prev, name)) for name in _FEATURE_DTYPES}
    scalars = {name: torch.tensor(int(_field(fields, name)), dtype=torch.int32,
                                  device=dev) for name in _SCAN_SCALARS}
    return ScanState(
        m=map_state_from_numpy(_field(fields, "m"), dev),
        prev=features_from_numpy(prev, dev),
        T_wc=f32(_field(fields, "T_wc")), velocity=f32(_field(fields, "velocity")),
        generator=make_generator(seed, dev),
        ba_edges_dropped=torch.zeros((), dtype=torch.int32, device=dev),
        **scalars)


def scan_state_to_numpy(state: ScanState) -> dict:
    """All array fields of the state (the generator is left out)."""
    out = {"m": map_state_to_numpy(state.m),
           "prev": features_to_numpy(state.prev),
           "T_wc": state.T_wc.cpu().numpy(),
           "velocity": state.velocity.cpu().numpy()}
    out.update({name: np.int32(getattr(state, name).cpu())
                for name in _SCAN_SCALARS})
    return out
