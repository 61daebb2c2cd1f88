"""The one traffic generator: a cell's frames and their ground truth, made
from the configuration (the rig) and the traffic mix (the room and the
trajectory) and the run's seed.

The room is the mix's own (textures drawn from its `room_seed`), as a
dataset is one recorded scene; the run's seed picks where on the lap the
stream starts, the sensor's noise and the program's random draws, so every
seed asks for the same work in another order.  The lap is rendered once on
the device by the frozen renderer; an RGB-D rig gets depth noise of
`depth_noise_z2` x z^2 from a generator on the device seeded with the seed,
in one call for the whole lap.  The frames then move to host memory (ordinary pageable float32
tensors, as a dataset's frames reach the program), and the stream replays
lap frame `i mod lap_frames`: `lap_trajectory` returns to its start pose
after a lap, so the stream is one continuous trajectory that revisits its
start every lap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.reference import render


class Lap(NamedTuple):
    firsts: torch.Tensor    # (L, H, W) grey (left image), host memory
    seconds: torch.Tensor   # (L, H, W) depth (m) or right image, host memory
    poses: np.ndarray       # (L, 4, 4) float64 camera-to-world ground truth
    intrinsics: np.ndarray  # (4,) fx fy cx cy
    stereo: bool

    @property
    def frames(self) -> int:
        return self.firsts.shape[0]

    def frame(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        j = i % self.frames
        return self.firsts[j], self.seconds[j]

    def truth(self, i: int) -> np.ndarray:
        """Ground-truth pose of stream frame `i` in the frame of stream
        frame 0 (the program's world frame)."""
        return np.linalg.inv(self.poses[0]) @ self.poses[i % self.frames]


def seed_value(seed: int) -> int:
    """Any whole number -> a non-negative seed for numpy and torch."""
    return int(seed) % (2 ** 63)


@torch.no_grad()
def make_lap(config: dict, traffic: dict, seed: int, device) -> Lap:
    if traffic["generator"] != "lap":
        raise ValueError(f"unknown traffic generator {traffic['generator']!r}")
    sensor = config["sensor"]
    shape = (sensor["height"], sensor["width"])
    n = int(traffic["lap_frames"])
    s = seed_value(seed)
    dev = torch.device(device)
    intr = torch.tensor(sensor["intrinsics"], dtype=torch.float32, device=dev)
    textures = torch.from_numpy(
        render.make_textures(int(traffic["room_seed"]))).to(dev)
    start = torch.remainder(torch.arange(n, device=dev) + s % n, n)
    poses = render.lap_trajectory(n, traffic["radius_m"], traffic["center_z_m"],
                                  n, device=dev)[start]
    firsts = torch.empty((n, *shape), dtype=torch.float32, device=dev)
    seconds = torch.empty_like(firsts)
    stereo = sensor["kind"] == "stereo"
    if stereo:
        shift = torch.eye(4, dtype=torch.float32, device=dev)
        shift[0, 3] = sensor["baseline_m"]
    for i in range(n):
        firsts[i], depth = render.render_frame(poses[i], intr, textures, shape)
        if stereo:
            seconds[i], _ = render.render_frame(poses[i] @ shift, intr,
                                                textures, shape)
        else:
            seconds[i] = depth
    if not stereo and sensor["depth_noise_z2"] > 0:
        g = torch.Generator(device=dev).manual_seed(s)
        noise = torch.randn(seconds.shape, generator=g, device=dev)
        seconds.mul_(1.0 + sensor["depth_noise_z2"] * seconds * noise)
        del noise
    return Lap(firsts=firsts.cpu(), seconds=seconds.cpu(),
               poses=poses.double().cpu().numpy(),
               intrinsics=intr.cpu().numpy(), stereo=stereo)
