"""IMU attitude filter of the PyTorch port vs the JAX package (CPU).  The
port folds a packet on the host in float32 numpy; `theta`, `last_ts` and
`delta_w` must agree to 1e-6 (a few f32 multiply-adds and one arctan2 per
sample)."""

import jax.numpy as jnp
import numpy as np
import pytest

from jetracer_orbslam2_tpu.io.synthetic import imu_from_poses as j_imu_from_poses
from jetracer_orbslam2_tpu.io.synthetic import lap_trajectory as j_lap_trajectory
from jetracer_orbslam2_tpu.models import imu as jimu

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.io.synthetic import imu_from_poses, lap_trajectory
from jetracer_orbslam2_torch.models import imu as timu

close = np.testing.assert_allclose


def _packets(seed, n_packets=6, n=8, m=5):
    """Masked fixed-size packets with increasing relative timestamps."""
    rng = np.random.default_rng(seed)
    ts0 = 0.0
    for _ in range(n_packets):
        gyro = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
        ts = (ts0 + np.cumsum(rng.uniform(0.002, 0.008, n))).astype(np.float32)
        ts0 = float(ts[-1])
        accel = (np.float32([0.3, 9.7, 0.8])
                 + rng.normal(0, 0.2, (m, 3))).astype(np.float32)
        yield gyro, ts, accel, rng.random(n) > 0.25, rng.random(m) > 0.4


def _jstate(s):
    return jimu.ImuState(theta=jnp.asarray(s.theta), last_ts=jnp.float32(s.last_ts),
                         initialized=jnp.asarray(bool(s.initialized)))


def _assert_state(ts, js):
    close(ts.theta, np.asarray(js.theta), rtol=0, atol=1e-6)
    close(ts.last_ts, np.asarray(js.last_ts), rtol=0, atol=1e-6)
    assert bool(ts.initialized) == bool(js.initialized)
    assert ts.theta.dtype == np.float32


def test_init_state_matches():
    _assert_state(timu.init_state(), jimu.init_state())


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_packets_match(seed):
    ts_, js_ = timu.init_state(), jimu.init_state()
    for g, gts, a, gok, aok in _packets(seed):
        js_, j_dw = jimu.process_packet_with_delta(
            js_, jnp.asarray(g), jnp.asarray(gts), jnp.asarray(a),
            jnp.asarray(gok), jnp.asarray(aok))
        ts_, t_dw = timu.process_packet_with_delta(ts_, g, gts, a, gok, aok)
        close(t_dw, np.asarray(j_dw), rtol=0, atol=1e-6)
        _assert_state(ts_, js_)
    assert bool(ts_.initialized) and np.abs(ts_.theta).max() > 1e-3


def test_all_masked_packet_changes_nothing():
    state = timu.process_accel(timu.init_state(), [0.0, 9.81, 0.0])
    g, gts, a, _, _ = next(_packets(3))
    out, dw = timu.process_packet_with_delta(
        state, g, gts, a, np.zeros(8, bool), np.zeros(5, bool))
    np.testing.assert_array_equal(out.theta, state.theta)
    assert out.last_ts == state.last_ts and not dw.any()
    assert timu.process_packet(state, g, gts, a, np.zeros(8, bool),
                               np.zeros(5, bool)).last_ts == state.last_ts


def test_epoch_timestamp_guard():
    """Absolute-looking timestamps (epoch seconds) neither integrate nor
    latch; a non-monotonic one latches without integrating."""
    ts_ = timu.process_gyro(timu.init_state(), [0.1, 0.2, 0.3], 0.5)
    js_ = jimu.process_gyro(jimu.init_state(), jnp.float32([0.1, 0.2, 0.3]),
                            jnp.float32(0.5))
    _assert_state(ts_, js_)                      # first sample only latches
    for gyro, stamp in (([1.0, 0.0, 0.0], 1.4e9), ([0.0, 1.0, 0.0], 0.75),
                        ([0.0, 0.0, 1.0], 0.6), ([0.5, 0.5, 0.5], 0.9)):
        ts_ = timu.process_gyro(ts_, gyro, stamp)
        js_ = jimu.process_gyro(js_, jnp.float32(gyro), jnp.float32(stamp))
        _assert_state(ts_, js_)
    close(ts_.theta, [0.15, 0.4, 0.15], rtol=0, atol=1e-6)
    assert ts_.last_ts == np.float32(0.9)


def test_process_accel_matches():
    ts_, js_ = timu.init_state(), jimu.init_state()
    for accel in ([0.4, 9.6, 1.0], [-0.2, 9.8, 0.5], [0.0, 9.81, 0.0]):
        ts_ = timu.process_accel(ts_, accel)
        js_ = jimu.process_accel(js_, jnp.float32(accel))
        _assert_state(ts_, js_)


def test_imu_from_poses_and_filter_over_a_lap():
    """The synthesized packets of a lap agree, and folding them recovers the
    inter-frame yaw step in delta_w."""
    j_poses = np.asarray(j_lap_trajectory(12, lap_frames=40))
    t_poses = lap_trajectory(12, lap_frames=40)
    close(t_poses.numpy(), j_poses, rtol=0, atol=1e-6)
    want = j_imu_from_poses(jnp.asarray(j_poses), noise_gyro=0.01, noise_accel=0.02)
    got = imu_from_poses(t_poses, noise_gyro=0.01, noise_accel=0.02)
    for g, w in zip(got, want):
        close(np.asarray(g, np.float32), np.asarray(w, np.float32), rtol=0, atol=2e-5)
    clean = imu_from_poses(t_poses)
    state = timu.init_state()
    for i in range(12):
        state, dw = timu.process_packet_with_delta(state, *(c[i] for c in clean))
        if i:
            close(dw, [0.0, 2 * np.pi / 40, 0.0], rtol=0, atol=1e-4)


def test_imu_state_round_trip():
    state = timu.process_accel(timu.init_state(), [0.4, 9.6, 1.0])
    back = convert.imu_state_from_numpy(convert.imu_state_to_numpy(state))
    np.testing.assert_array_equal(back.theta, state.theta)
    assert back.last_ts == state.last_ts and back.initialized == state.initialized
    from_jax = convert.imu_state_from_numpy(_jstate(state))
    np.testing.assert_array_equal(from_jax.theta, state.theta)
