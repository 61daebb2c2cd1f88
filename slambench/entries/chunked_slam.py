"""Program entry `chunked_slam`: `jetracer_orbslam2_torch.models.slam_scan.
ChunkedSlam`, built as `run.py --mode slam --chunked C` builds it (stereo
when the configuration has a `stereo` section), fed one host frame a call.

It hands the program frames and reads back what the program answers: each
chunk's rows, its trajectory, its keyframes as stored in its map, and its
counters.  (The entries, `harness/native.py`, which builds the program's
kernels, and the tests' planted faults are the benchmark's only files that
import the program.)
"""

from __future__ import annotations

import numpy as np
import torch


def system_config(config: dict):
    """The program's `SystemConfig` from the configuration's `system`."""
    from jetracer_orbslam2_torch.config import (
        BAConfig, FrontendConfig, MapConfig, StereoConfig, SystemConfig,
        TrackingConfig)

    s = config["system"]
    return SystemConfig(
        frontend=FrontendConfig(**s["frontend"]),
        tracking=TrackingConfig(**s["tracking"]),
        map=MapConfig(**s["map"]), ba=BAConfig(**s["ba"]),
        stereo=StereoConfig(**s["stereo"]) if s.get("stereo") else None)


class Entry:
    def __init__(self, config: dict, traffic: dict, intrinsics: np.ndarray,
                 seed: int, device):
        from jetracer_orbslam2_torch.models.slam_scan import ChunkedSlam

        self.cfg = system_config(config)
        self.ch = ChunkedSlam(self.cfg, torch.from_numpy(intrinsics),
                              chunk_size=int(traffic["chunk_size"]),
                              seed=seed, device=device)

    def feed(self, first: torch.Tensor, second: torch.Tensor):
        """Hand one frame (grey and depth, or left and right); returns the
        chunk's rows ({"tracked", "is_kf"}, numpy) when it completes one."""
        out = self.ch.process_frame(first, second)
        if out is None:
            return None
        return {"tracked": np.asarray(out.tracked, bool),
                "is_kf": np.asarray(out.is_kf, bool)}

    def counters(self) -> dict:
        st = self.ch.state
        out = {"loops": int(st.num_loops), "relocs": int(st.num_relocs),
               "keyframes_live": int(st.m.kf_valid.sum()),
               "keyframes_culled": int(st.m.num_dead),
               "landmarks": int(st.m.num_lm), "route": st.route}
        for name in ("captures", "replays", "cache_hits"):
            out[name] = getattr(st.graph, name, 0)
        return out

    def results(self) -> dict:
        """What the program answered, on the host: every frame's world pose
        (each riding its reference keyframe's final pose), its tracked flag,
        and the live keyframes of the map (their frame, final pose and the
        front-end's features as the map stored them)."""
        m = self.ch.state.m
        live = m.kf_valid
        kf = {name: getattr(m, "kf_" + name)[live].cpu().numpy()
              for name in ("frame_id", "pose", "xy", "desc", "points",
                           "has_point")}
        feats = {k: kf[k] for k in ("xy", "desc", "points", "has_point")}
        feats["frame"] = kf["frame_id"].astype(np.int64)
        return {"trajectory": np.asarray(self.ch.result(), np.float64),
                "tracked": np.asarray(self.ch.tracked(), bool),
                "features": feats,
                "keyframes": {"frame": feats["frame"], "pose": kf["pose"]},
                "loops": int(self.ch.state.num_loops)}

    def close(self) -> None:
        """Free the program's state and its captured graphs."""
        from jetracer_orbslam2_torch.utils.step_graph import clear_graph_cache

        self.ch = None
        clear_graph_cache()
        torch.cuda.empty_cache()
