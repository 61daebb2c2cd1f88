"""The comparison that decides `correct`: what the timed path produced,
against the plain references, once the window has closed and the program's
state is freed.

- Front-end: the features the program kept for frames of the window (its
  keyframes, or the odometry state's last frame of sampled chunks; a sample
  drawn from the seed), against the plain front-end run on the same frames:
  keypoint slots whose position, depth flag or back-projected point differ,
  and descriptor bits that differ.
- Tracking: every frame of the window, its world pose against the
  renderer's exact pose (RMSE after the rigid alignment) and its motion from
  the frame before against the exact motion; frames untracked; frames
  handed in the window that never came back.
- Back-end: the map's live keyframes, their poses after BA and loop
  closure against the exact poses; loops closed per lap of the window.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slambench.reference import frontend, trajectory


def popcount32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    return np.unpackbits(x.view(np.uint8)).reshape(*x.shape, 32).sum(-1)


def sample_frames(frame_ids: np.ndarray, lo: int, hi: int, seed: int,
                  count: int) -> np.ndarray:
    """Indices of up to `count` of the frames the program kept features of
    whose frame lies in [lo, hi), drawn from the seed (all of them if none
    does)."""
    pool = np.flatnonzero((frame_ids >= lo) & (frame_ids < hi))
    if pool.size == 0:
        pool = np.arange(frame_ids.size)
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    take = rng.choice(pool.size, size=min(count, pool.size), replace=False)
    return np.sort(pool[take])


def reference_features(lap, frame_ids, config: dict, device,
                       pixel_dtype=torch.float32) -> list[dict]:
    """The plain front-end's features (numpy) of each stream frame."""
    s = config["system"]
    fe, tr = s["frontend"], s["tracking"]
    intr = torch.as_tensor(lap.intrinsics, dtype=torch.float32, device=device)
    out = []
    for fid in frame_ids:
        first, second = (t.to(device) for t in lap.frame(int(fid)))
        if lap.stereo:
            f = frontend.features_stereo(first, second, intr, fe, s["stereo"],
                                         tr["min_depth"], tr["max_depth"],
                                         pixel_dtype)
        else:
            f = frontend.features_rgbd(first, second, intr, fe,
                                       tr["min_depth"], tr["max_depth"],
                                       pixel_dtype)
        out.append({k: v.cpu().numpy() for k, v in f.items()})
    return out


def frontend_numbers(program: list[dict], reference: list[dict]) -> dict:
    """Over every keypoint slot of the sampled frames: the share of slots
    whose position, depth flag or back-projected point is not the
    reference's, and the share of descriptor bits that differ where the
    positions agree."""
    slots = differ = bits = bits_total = 0
    for p, r in zip(program, reference):
        same_xy = np.all(p["xy"] == r["xy"], axis=-1)
        same = (same_xy & (p["has_point"] == r["has_point"])
                & np.all(p["points"] == r["points"], axis=-1))
        slots += same.size
        differ += int(np.sum(~same))
        if same_xy.any():
            bits += int(popcount32(p["desc"][same_xy] ^ r["desc"][same_xy]).sum())
            bits_total += int(same_xy.sum()) * 32 * p["desc"].shape[-1]
    return {"fe_kp_differ_pct": 100.0 * differ / max(slots, 1),
            "fe_desc_bits_pct": 100.0 * bits / max(bits_total, 1)}


def relative_errors(traj: np.ndarray, lap, idx: np.ndarray) -> np.ndarray:
    """Per frame i of `idx`: the translation error (m) of the program's
    motion from frame i - 1 to i against the exact motion."""
    est = np.linalg.inv(traj[idx - 1]) @ traj[idx]
    gt = np.stack([np.linalg.inv(lap.truth(i - 1)) @ lap.truth(i) for i in idx])
    return np.linalg.norm((np.linalg.inv(gt) @ est)[:, :3, 3], axis=-1)


def pose_numbers(results: dict, lap, window, loops_before: int,
                 loops_after: int) -> dict:
    """Tracking: every frame of the window against the exact poses; and,
    for an entry with a map, its live keyframes and its loops."""
    lo, hi = window.start, window.start + window.handed
    traj, tracked = results["trajectory"], results["tracked"]
    returned = sum(len(r["tracked"]) for r in window.rows)
    out = {"missing_frames": float(window.handed - returned)}
    idx = np.arange(max(lo, 1), min(hi, traj.shape[0]))
    if idx.size == 0:           # no answer came back for the window
        return out
    truth = np.stack([lap.truth(i) for i in idx])
    out.update({
        "track_rmse_cm": 100.0 * trajectory.rmse(
            trajectory.position_errors(traj[idx], truth)),
        "rpe_rmse_mm": 1e3 * trajectory.rmse(relative_errors(traj, lap, idx)),
        "untracked_pct": 100.0 * float(np.mean(~tracked[idx]))})
    kf = results.get("keyframes")
    if kf is not None:
        kf_truth = np.stack([lap.truth(int(i)) for i in kf["frame"]])
        out["kf_rmse_cm"] = 100.0 * trajectory.rmse(trajectory.position_errors(
            kf["pose"].astype(np.float64), kf_truth))
        out["loops_per_lap"] = (loops_after - loops_before) / (
            window.handed / lap.frames)
    return out


def compare(results: dict, lap, window, cell, seed: int, device,
            loops_before: int, loops_after: int) -> dict:
    """Every number `correct` can compare, from the program's results."""
    feats = results["features"]
    picks = sample_frames(feats["frame"], window.start,
                             window.start + window.handed, seed,
                             int(cell.traffic["check_frames"]))
    ref = reference_features(lap, feats["frame"][picks], cell.config, device)
    program = [{k: feats[k][i] for k in ("xy", "desc", "points", "has_point")}
               for i in picks]
    numbers = frontend_numbers(program, ref)
    numbers.update(pose_numbers(results, lap, window, loops_before,
                                loops_after))
    return numbers


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a limit
    is {"max": x} (the number may not exceed x) or {"min": x}."""
    checks, ok = {}, True
    for name, lim in limits["numbers"].items():
        value = float(numbers.get(name, math.nan))
        if "max" in lim:
            bound, good = lim["max"], value <= lim["max"]
        else:
            bound, good = lim["min"], value >= lim["min"]
        good = good and not math.isnan(value)
        ok = ok and good
        checks[name] = {"value": None if math.isnan(value) else value,
                        "limit": bound,
                        "holds": "max" if "max" in lim else "min"}
    return ok, checks
