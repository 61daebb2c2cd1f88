"""IMU attitude estimation: gyro integration + accel complementary filter.

Counterpart of `jetracer_orbslam2_tpu/models/imu.py`: `process_gyro`
integrates angular rate into Euler angles `theta`; `process_accel` extracts
the gravity direction and blends with alpha = 0.98.

The state update is a few scalar operations per sample, and a per-frame packet
holds some seven 200 Hz samples.  The JAX package scans the packet in one
compiled dispatch; run eagerly on the card each sample would be a dozen
tiny launches.  The packets arrive from the loaders as numpy arrays, so here
the filter runs on the host in float32 numpy, sample by sample in the same
order, and only `delta_w` (the tracker's motion prior) moves to the device,
once per frame, by whoever consumes it.

Timestamps are RELATIVE seconds since sequence start, never epoch seconds:
float32 resolution at epoch magnitudes (~1.4e9 s) is ~128 s, which would turn
every dt into garbage.  `process_gyro` guards against absolute-looking inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

ALPHA = np.float32(0.98)  # complementary blend

# Relative timestamps beyond this are certainly a unit bug (a day-long
# sequence is 9e4 s; epoch seconds are 1e9).  Samples past the horizon are
# ignored rather than silently integrating a ~128 s-quantized dt.
MAX_REL_TS = np.float32(1e6)

_F32 = np.float32


class ImuState(NamedTuple):
    theta: np.ndarray        # (3,) float32 roll/pitch/yaw-ish Euler attitude [rad]
    last_ts: np.float32      # RELATIVE seconds since sequence start
    initialized: np.bool_    # first accel sample seeds theta


def init_state() -> ImuState:
    return ImuState(theta=np.zeros(3, _F32), last_ts=_F32(-1.0),
                    initialized=np.bool_(False))


def process_gyro(state: ImuState, gyro, ts) -> ImuState:
    """Integrate angular rate (rad/s) over the timestamp delta.

    `ts` is relative seconds.  The first sample (and any non-monotonic or
    absolute-epoch timestamp) only latches `last_ts` without integrating.
    """
    gyro, ts = np.asarray(gyro, _F32), _F32(ts)
    ok = (state.last_ts >= 0.0) and (ts > state.last_ts) and (ts < MAX_REL_TS)
    dt = _F32(ts - state.last_ts) if ok else _F32(0.0)
    theta = (state.theta + gyro * dt).astype(_F32)
    new_ts = ts if ts < MAX_REL_TS else state.last_ts
    return ImuState(theta=theta, last_ts=_F32(new_ts),
                    initialized=state.initialized)


def process_accel(state: ImuState, accel) -> ImuState:
    """Blend gravity direction into roll/pitch (yaw unobservable from accel).

    accel: (3,) m/s^2 in body frame.  The first sample seeds the attitude
    directly."""
    ax, ay, az = np.asarray(accel, _F32)
    roll = np.arctan2(ay, np.sqrt(ax * ax + az * az))
    pitch = np.arctan2(-ax, np.sqrt(ay * ay + az * az))
    accel_theta = np.stack([roll, pitch, state.theta[2]]).astype(_F32)
    if state.initialized:
        theta = (ALPHA * state.theta + (_F32(1.0) - ALPHA) * accel_theta)
    else:
        theta = accel_theta
    return ImuState(theta=theta.astype(_F32), last_ts=state.last_ts,
                    initialized=np.bool_(True))


def process_packet_with_delta(
    state: ImuState,
    gyro,          # (N, 3) rad/s
    gyro_ts,       # (N,) relative s
    accel,         # (M, 3) m/s^2
    gyro_valid,    # (N,) bool (fixed-size packet with mask)
    accel_valid,   # (M,) bool
) -> tuple[ImuState, np.ndarray]:
    """Fold a fixed-size batch of IMU samples into the state.

    Also returns delta_w (3,) float32: the gyro-integrated body rotation
    vector over this packet, i.e. the rotation between the previous and the
    current camera frame, the IMU-aided motion prior the tracker consumes
    (`models/slam.track_and_associate`)."""
    gyro = np.asarray(gyro, _F32)
    gyro_ts = np.asarray(gyro_ts, _F32)
    accel = np.asarray(accel, _F32)
    theta_before = state.theta
    for g, ts, v in zip(gyro, gyro_ts, np.asarray(gyro_valid, bool)):
        if v:
            state = process_gyro(state, g, ts)
    delta_w = (state.theta - theta_before).astype(_F32)
    for a, v in zip(accel, np.asarray(accel_valid, bool)):
        if v:
            state = process_accel(state, a)
    return state, delta_w


def process_packet(state: ImuState, gyro, gyro_ts, accel, gyro_valid,
                   accel_valid) -> ImuState:
    """Attitude-only wrapper around `process_packet_with_delta`."""
    state, _ = process_packet_with_delta(
        state, gyro, gyro_ts, accel, gyro_valid, accel_valid)
    return state
