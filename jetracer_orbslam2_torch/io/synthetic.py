"""Synthetic RGB-D sequence generator with exact ground truth.

Counterpart of `jetracer_orbslam2_tpu/io/synthetic.py`: the forward-arc and lap
generators, RGB-D and stereo, and the IMU synthesizer.  The scene
is the inside of a textured box "room", ray-cast per pixel: photometrically
consistent across views, exact depth, exact poses.

Textures come from a numpy generator seeded by `seed` (the JAX package draws
them with `jax.random`, whose stream cannot be reproduced here);
`render_frame` and the stereo generators take the textures as an argument, so
a test can hand both renderers the same ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.utils.device import resolve_device

Tensor = torch.Tensor


class SyntheticStereoSequence(NamedTuple):
    left: Tensor     # (N, H, W) float32 in [0, 255]
    right: Tensor    # (N, H, W)
    depth: Tensor    # (N, H, W) left-camera ground-truth depth
    poses: Tensor    # (N, 4, 4) T_wc of the LEFT camera
    intrinsics: Tensor  # (4,) fx fy cx cy, both cameras
    baseline: float


class SyntheticSequence(NamedTuple):
    gray: Tensor     # (N, H, W) float32 in [0, 255]
    depth: Tensor    # (N, H, W) float32 meters (0 where no hit)
    poses: Tensor    # (N, 4, 4) T_wc ground truth (camera -> world)
    intrinsics: Tensor  # (4,) fx fy cx cy


# Box planes: (normal, offset, texture-axis-u, texture-axis-v)
# Camera starts at origin looking +z; y is down.
_PLANES = (
    ((0.0, 0.0, 1.0), 5.0, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),    # back wall z=5
    ((1.0, 0.0, 0.0), -2.5, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),   # left wall x=-2.5
    ((1.0, 0.0, 0.0), 2.5, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),    # right wall x=2.5
    ((0.0, 1.0, 0.0), 1.8, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),    # floor y=1.8
    ((0.0, 1.0, 0.0), -1.8, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),   # ceiling y=-1.8
    # front wall z=-3: closes the room; forward-facing trajectories never
    # cast rays toward it
    ((0.0, 0.0, 1.0), -3.0, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
)
NUM_PLANES = len(_PLANES)


def make_texture(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """High-corner-density texture: random blocky mosaic + multiscale noise.

    Blocky structure gives FAST strong corners; smooth noise decorrelates
    patches so BRIEF descriptors are distinctive.  (size, size) float32.
    """
    coarse = rng.random((size // 16, size // 16), dtype=np.float32)
    blocks = np.kron(coarse, np.ones((16, 16), np.float32))
    mid = np.kron(rng.random((size // 4, size // 4), dtype=np.float32),
                  np.ones((4, 4), np.float32))
    fine = rng.random((size, size), dtype=np.float32)
    tex = 0.6 * blocks + 0.3 * mid + 0.1 * fine
    return (tex * 255.0).astype(np.float32)


def make_textures(seed: int = 0, size: int = 256) -> np.ndarray:
    """(NUM_PLANES, size, size) float32 textures, one per box plane."""
    rng = np.random.default_rng(seed)
    return np.stack([make_texture(rng, size) for _ in range(NUM_PLANES)])


def _sample_texture(tex: Tensor, u: Tensor, v: Tensor, scale: float = 64.0) -> Tensor:
    """Bilinear, wrapping texture lookup at world coords scaled to texels."""
    size = tex.shape[0]
    x = u * scale
    y = v * scale
    xf = torch.floor(x)
    yf = torch.floor(y)
    fx = x - xf
    fy = y - yf
    x0 = xf.long()
    y0 = yf.long()

    def at(yi, xi):
        return tex[torch.remainder(yi, size), torch.remainder(xi, size)]

    return (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x0 + 1) * fx * (1 - fy)
        + at(y0 + 1, x0) * (1 - fx) * fy
        + at(y0 + 1, x0 + 1) * fx * fy
    )


@torch.no_grad()
def render_frame(
    T_wc: Tensor,
    intrinsics: Tensor,
    textures: Tensor,   # (num_planes, S, S)
    shape: tuple = (480, 640),
    dist: tuple | None = None,
    dist_model: str = "brown_conrady",
) -> tuple[Tensor, Tensor]:
    """Ray-cast one camera view of the box.  Returns (gray, depth), on the
    device of `T_wc`.

    `dist`: optional lens distortion (FrontendConfig.dist convention) —
    pixel (x, y) then images the ray through the UNDISTORTED normalized
    coords; depth stays the camera-z of the hit."""
    h, w = shape
    dev = T_wc.device
    f32 = torch.float32
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    yy = torch.arange(h, dtype=f32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)
    xn, yn = (xx - cx) / fx, (yy - cy) / fy
    if dist is not None:
        xyn = geo._UNDISTORT[dist_model](
            torch.stack([xn, yn], -1),
            torch.tensor(dist, dtype=f32, device=dev))
        xn, yn = xyn[..., 0], xyn[..., 1]
    # camera-frame ray directions (z=1 plane)
    d_cam = torch.stack([xn, yn, torch.ones((h, w), dtype=f32, device=dev)], -1)
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    d_w = d_cam @ R.T                                   # (H, W, 3)

    best_t = torch.full((h, w), float("inf"), dtype=f32, device=dev)
    best_val = torch.zeros((h, w), dtype=f32, device=dev)
    for i, (n, c, ax_u, ax_v) in enumerate(_PLANES):
        n = torch.tensor(n, dtype=f32, device=dev)
        ax_u = torch.tensor(ax_u, dtype=f32, device=dev)
        ax_v = torch.tensor(ax_v, dtype=f32, device=dev)
        denom = d_w @ n
        t = (c - o @ n) / torch.where(torch.abs(denom) < 1e-9,
                                      torch.full_like(denom, 1e-9), denom)
        # o + t*d with ONE rounding (what a fused multiply-add gives, and what
        # XLA emits for the JAX renderer): texel coordinates are hit * 64, so
        # a second rounding here shows as ~5e-3 grey levels at texture edges
        hit = (o.double() + t[..., None].double() * d_w.double()).float()
        val = _sample_texture(textures[i], hit @ ax_u, hit @ ax_v)
        ok = (t > 0.1) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_val = torch.where(ok, val, best_val)

    # the ray parameter t runs along d_w with d_cam z = 1, so the camera z of
    # the hit is t itself
    depth = torch.where(torch.isfinite(best_t), best_t, torch.zeros_like(best_t))
    return best_val, depth


def smooth_trajectory(n_frames: int, step: float = 0.02,
                      yaw_rate: float = 0.004, device="cpu") -> Tensor:
    """(N, 4, 4) T_wc poses: gentle forward arc with yaw + small sway."""
    i = torch.arange(n_frames, dtype=torch.float32, device=device)
    yaw = yaw_rate * i
    x = 0.4 * torch.sin(0.05 * i)
    y = 0.1 * torch.sin(0.03 * i)
    z = step * i
    w = torch.stack([torch.zeros_like(yaw), yaw, torch.zeros_like(yaw)], -1)
    R = geo.so3_exp(w)
    t = torch.stack([x, y, z], -1)
    return geo.pose_from_rt(R, t)


def lap_trajectory(
    n_frames: int,
    radius: float = 1.2,
    center_z: float = 2.0,
    lap_frames: int | None = None,
    device="cpu",
) -> Tensor:
    """(N, 4, 4) T_wc poses: clockwise lap(s) around a circle inside the box
    room; after `lap_frames` frames the camera is back at the start pose
    (same position AND heading) and keeps going into a second lap.

    The overshoot matters: the frames after `lap_frames` RE-OBSERVE the
    first frames' exact views, the revisit that loop-closure detection
    needs.  Callers that only want the closed circle pass
    n_frames == lap_frames + 1.
    """
    if lap_frames is None:
        lap_frames = n_frames - 1
    i = torch.arange(n_frames, dtype=torch.float32, device=device)
    phi = 2.0 * np.pi * i / lap_frames
    x = radius * torch.sin(phi)
    z = center_z - radius * torch.cos(phi)
    w = torch.stack([torch.zeros_like(phi), phi, torch.zeros_like(phi)], -1)
    R = geo.so3_exp(w)
    t = torch.stack([x, torch.zeros_like(x), z], -1)
    return geo.pose_from_rt(R, t)


def _intrinsics(shape: tuple, dev) -> Tensor:
    h, w = shape
    return torch.tensor([0.9 * w, 0.9 * w, (w - 1) / 2.0, (h - 1) / 2.0],
                        dtype=torch.float32, device=dev)


def _render_stack(poses: Tensor, intr: Tensor, textures: Tensor, shape: tuple,
                  dist=None, dist_model: str = "brown_conrady",
                  with_depth: bool = True):
    """Render one frame per pose on the poses' device, straight into
    preallocated (N, H, W) stacks: a long sequence (1,200 frames of 640x480
    are 2.9 GB of gray + depth) never holds more than one frame's
    temporaries beside them.  Returns (gray, depth or None)."""
    dev = poses.device
    n = poses.shape[0]
    gray = torch.empty((n, *shape), dtype=torch.float32, device=dev)
    depth = (torch.empty((n, *shape), dtype=torch.float32, device=dev)
             if with_depth else None)
    for i in range(n):
        g, d = render_frame(poses[i], intr, textures, shape, dist=dist,
                            dist_model=dist_model)
        gray[i] = g
        if with_depth:
            depth[i] = d
    return gray, depth


def _render_sequence(poses: Tensor, shape: tuple, seed: int, dist=None,
                     dist_model: str = "brown_conrady") -> SyntheticSequence:
    intr = _intrinsics(shape, poses.device)
    textures = torch.from_numpy(make_textures(seed)).to(poses.device)
    gray, depth = _render_stack(poses, intr, textures, shape, dist, dist_model)
    return SyntheticSequence(gray=gray, depth=depth, poses=poses, intrinsics=intr)


def _render_stereo(poses: Tensor, shape: tuple, seed: int, textures,
                   baseline: float, dist_l=None, dist_r=None,
                   dist_model: str = "brown_conrady",
                   right_rotation=None) -> SyntheticStereoSequence:
    """Stereo pairs along `poses`: the right camera is the left one shifted by
    `baseline` along its +x axis, then rotated by `right_rotation`
    (axis-angle, rad) when given.  `textures` (numpy, (NUM_PLANES, S, S))
    replaces the ones drawn from `seed`."""
    dev = poses.device
    f32 = torch.float32
    intr = _intrinsics(shape, dev)
    tex = make_textures(seed) if textures is None else np.array(textures, np.float32)
    tex = torch.from_numpy(tex).to(dev)
    shift = torch.eye(4, dtype=f32, device=dev)
    shift[0, 3] = baseline
    if right_rotation is not None:
        Rr = geo.so3_exp(torch.tensor(right_rotation, dtype=f32, device=dev))
        shift = shift @ geo.pose_from_rt(Rr, torch.zeros(3, dtype=f32, device=dev))
    left, depth = _render_stack(poses, intr, tex, shape, dist_l, dist_model)
    right, _ = _render_stack(poses @ shift, intr, tex, shape, dist_r,
                             dist_model, with_depth=False)
    return SyntheticStereoSequence(left=left, right=right, depth=depth,
                                   poses=poses, intrinsics=intr,
                                   baseline=baseline)


@torch.no_grad()
def generate_stereo_sequence(
    n_frames: int = 10,
    shape: tuple = (480, 640),
    seed: int = 0,
    step: float = 0.02,
    yaw_rate: float = 0.004,
    baseline: float = 0.11,
    dist_l: tuple | None = None,
    dist_r: tuple | None = None,
    dist_model: str = "brown_conrady",
    right_rotation: tuple | None = None,
    textures=None,
    device=None,
) -> SyntheticStereoSequence:
    """Stereo pairs along `smooth_trajectory` (EuRoC/KITTI geometry), on
    `cuda:0` unless `device` says otherwise.  `dist_l` / `dist_r` render
    distorted lenses and `right_rotation` tilts the right camera: together a
    geometrically exact rig that is NOT pre-rectified."""
    dev = resolve_device(device)
    poses = smooth_trajectory(n_frames, step, yaw_rate, device=dev)
    return _render_stereo(poses, shape, seed, textures, baseline, dist_l,
                          dist_r, dist_model, right_rotation)


@torch.no_grad()
def generate_stereo_lap_sequence(
    n_frames: int = 180,
    shape: tuple = (240, 320),
    seed: int = 0,
    radius: float = 1.2,
    lap_frames: int = 160,
    baseline: float = 0.11,
    textures=None,
    device=None,
) -> SyntheticStereoSequence:
    """A lap-plus-overshoot stereo sequence (see `lap_trajectory`): the
    loop-closure workload in the EuRoC-rig geometry, on `cuda:0` unless
    `device` says otherwise."""
    dev = resolve_device(device)
    poses = lap_trajectory(n_frames, radius=radius, lap_frames=lap_frames,
                           device=dev)
    return _render_stereo(poses, shape, seed, textures, baseline)


@torch.no_grad()
def generate_lap_sequence(
    n_frames: int = 180,
    shape: tuple = (240, 320),
    seed: int = 0,
    radius: float = 1.2,
    lap_frames: int = 160,
    device=None,
) -> SyntheticSequence:
    """A lap-plus-overshoot RGB-D sequence (see `lap_trajectory`) for loop
    closure and relocalization, on `cuda:0` unless `device` says otherwise."""
    dev = resolve_device(device)
    poses = lap_trajectory(n_frames, radius=radius, lap_frames=lap_frames,
                           device=dev)
    return _render_sequence(poses, shape, seed)


def imu_from_poses(
    poses,
    fps: float = 30.0,
    rate: float = 200.0,
    g: float = 9.81,
    seed: int = 0,
    noise_gyro: float = 0.0,
    noise_accel: float = 0.0,
):
    """Synthesize per-frame IMU packets from ground-truth poses.

    For each inter-frame interval the body rate is the constant twist
    omega = log(R_i^T R_{i+1}) * fps (exact for constant-twist trajectories
    like laps), sampled at `rate` Hz; the accelerometer measures the gravity
    direction in the body frame (y-down world: g_world = (0, g, 0)), the
    quantity the complementary filter consumes.

    Returns (gyro (N, S, 3), gyro_ts (N, S) relative s, accel (N, S, 3),
    gyro_valid (N, S), accel_valid (N, S)) numpy arrays: packet i holds the
    samples between frame i-1 and frame i (packet 0 is a single seed
    sample).
    """
    P = poses.cpu().numpy() if isinstance(poses, Tensor) else np.asarray(poses)
    P = P.astype(np.float32)
    n = P.shape[0]
    S = max(1, int(np.ceil(rate / fps)))
    rel = np.einsum("nij,njk->nik", P[:-1, :3, :3].transpose(0, 2, 1),
                    P[1:, :3, :3])
    omega = geo.so3_log(torch.from_numpy(rel)).numpy() * fps
    rng = np.random.RandomState(seed)

    gyro = np.zeros((n, S, 3), np.float32)
    gyro_ts = np.zeros((n, S), np.float32)
    accel = np.zeros((n, S, 3), np.float32)
    gyro_valid = np.zeros((n, S), bool)
    accel_valid = np.zeros((n, S), bool)
    g_world = np.asarray([0.0, g, 0.0], np.float32)
    for i in range(n):
        if i == 0:
            accel[0, 0] = P[0, :3, :3].T @ g_world
            accel_valid[0, 0] = True
            gyro_ts[0, 0] = 0.0
            gyro_valid[0, 0] = True        # latches last_ts, integrates 0
            continue
        t0, t1 = (i - 1) / fps, i / fps
        ts = t0 + (np.arange(S) + 1) * (t1 - t0) / S
        gyro[i] = omega[i - 1][None, :]
        gyro_ts[i] = ts
        gyro_valid[i] = True
        accel[i] = (P[i, :3, :3].T @ g_world)[None, :]
        accel_valid[i] = True
    if noise_gyro:
        gyro += rng.randn(*gyro.shape).astype(np.float32) * noise_gyro
    if noise_accel:
        accel += rng.randn(*accel.shape).astype(np.float32) * noise_accel
    return gyro, gyro_ts, accel, gyro_valid, accel_valid


@torch.no_grad()
def generate_sequence(
    n_frames: int = 30,
    shape: tuple = (480, 640),
    seed: int = 0,
    step: float = 0.02,
    yaw_rate: float = 0.004,
    dist: tuple | None = None,
    dist_model: str = "brown_conrady",
    device=None,
) -> SyntheticSequence:
    """Render an RGB-D sequence along `smooth_trajectory`, on `cuda:0` unless
    `device` says otherwise (frames are made on the device they are used on)."""
    dev = resolve_device(device)
    poses = smooth_trajectory(n_frames, step, yaw_rate, device=dev)
    return _render_sequence(poses, shape, seed, dist=dist, dist_model=dist_model)
