"""Program entry `chunked_odometry`: `jetracer_orbslam2_torch.models.
odometry.ChunkedOdometry`, built as `run.py --mode odometry --chunked C`
builds it, fed one host frame (grey, depth) a call.  RGB-D frame-to-frame
tracking with no map, no BA and no loop closure.

It hands the program frames and reads back what the program answers: each
chunk's tracked flags (the chunk's one fetch), every frame's world pose,
and the front-end's features of the chunk's last frame (the state's
`prev`) for every `check_every_chunks`-th chunk, counted from a phase the
seed sets; those are copied on the device, with no wait, when the chunk
returns.
"""

from __future__ import annotations

import numpy as np
import torch

FEATURES = ("xy", "desc", "points", "has_point")


class Entry:
    def __init__(self, config: dict, traffic: dict, intrinsics: np.ndarray,
                 seed: int, device):
        from jetracer_orbslam2_torch.config import FrontendConfig, TrackingConfig
        from jetracer_orbslam2_torch.models.odometry import ChunkedOdometry

        s = config["system"]
        self.chunk = int(traffic["chunk_size"])
        self.stride = int(traffic["check_every_chunks"])
        self.phase = seed % self.stride
        self.ch = ChunkedOdometry(
            torch.from_numpy(intrinsics), FrontendConfig(**s["frontend"]),
            TrackingConfig(**s["tracking"]), chunk_size=self.chunk, seed=seed,
            device=device)
        self.frames = 0
        self.samples: list = []       # (stream frame, {name: device copy})

    def feed(self, first: torch.Tensor, second: torch.Tensor):
        """Hand one frame; returns the chunk's rows ({"tracked", "is_kf"},
        numpy) when it completes one."""
        self.ch.process_frame(first, second)
        frame = self.frames
        self.frames += 1
        if frame == 0 or frame % self.chunk:
            return None
        chunk = frame // self.chunk
        if (chunk + self.phase) % self.stride == 0:
            prev = self.ch.state.prev
            self.samples.append(
                (frame, {k: getattr(prev, k).clone() for k in FEATURES}))
        ok = np.asarray(self.ch._ok[-1], bool)
        return {"tracked": ok, "is_kf": np.zeros(ok.shape, bool)}

    def counters(self) -> dict:
        graph = self.ch.state.graph
        out = {"loops": 0}
        for name in ("captures", "replays", "cache_hits"):
            out[name] = getattr(graph, name, 0)
        return out

    def results(self) -> dict:
        """Every frame's world pose and tracked flag, and the sampled
        frames' features, on the host."""
        poses, ok = self.ch.result()
        feats = {k: np.stack([s[1][k].cpu().numpy() for s in self.samples])
                 for k in FEATURES}
        feats["frame"] = np.asarray([s[0] for s in self.samples], np.int64)
        return {"trajectory": np.asarray(poses, np.float64),
                "tracked": np.asarray(ok, bool), "features": feats}

    def close(self) -> None:
        from jetracer_orbslam2_torch.utils.step_graph import clear_graph_cache

        self.ch = None
        self.samples = []
        clear_graph_cache()
        torch.cuda.empty_cache()
