"""SLAM back-end steps over the keyframe map.

Counterpart of `jetracer_orbslam2_tpu/models/slam.py`.  Ported so far:
`local_ba`, the windowed bundle adjustment that the running system applies
after a keyframe insert.  The tracking step against the map, the host
scheduler and loop closure follow with their modules.
"""

from __future__ import annotations

from typing import Optional

import torch

from jetracer_orbslam2_torch.config import SystemConfig
from jetracer_orbslam2_torch.models.backend.ba import BAProblem, bundle_adjust
from jetracer_orbslam2_torch.models.backend.map import MapState, _map_to
from jetracer_orbslam2_torch.utils.device import resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32
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
