"""`slam_scan` and `ChunkedSlam` of the PyTorch port (CPU): the scan must
reproduce the port's host-scheduled `Slam` (the same functions behind the same
host branches, the RANSAC generator advanced in the same order), chunking and
padding must not change the result, and on a small lap a loop closes in the
port as it does in the JAX package."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
from jetracer_orbslam2_tpu.config import MapConfig as JMapConfig
from jetracer_orbslam2_tpu.config import SystemConfig as JSystemConfig
from jetracer_orbslam2_tpu.config import TrackingConfig as JTrackingConfig
from jetracer_orbslam2_tpu.evaluation import ate as j_ate
from jetracer_orbslam2_tpu.io.synthetic import generate_lap_sequence as j_lap_sequence
from jetracer_orbslam2_tpu.io.synthetic import generate_sequence as j_generate_sequence
from jetracer_orbslam2_tpu.models import slam as jslam

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import (
    FrontendConfig, MapConfig, StereoConfig, SystemConfig, TrackingConfig)
from jetracer_orbslam2_torch.io.synthetic import imu_from_poses
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models import slam_scan as ss

from _torch_port_util import jax_features_to_numpy, n

close = np.testing.assert_allclose

H, W = 120, 160
MAP = dict(max_keyframes=16, max_landmarks=2048, max_obs=8192, kf_min_gap=2,
           kf_max_gap=4, window_size=4)
CFG = SystemConfig(
    frontend=FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=256),
    map=MapConfig(**MAP))


@pytest.fixture(scope="module")
def arc():
    """21 frames of the forward arc: 1 bootstrap + 4 chunks of 5."""
    seq = j_generate_sequence(n_frames=21, shape=(H, W))
    return (np.asarray(seq.gray), np.asarray(seq.depth),
            np.asarray(seq.intrinsics), np.asarray(seq.poses))


def _full_scan(gray, depth, intr, cfg=CFG, **kw):
    st = ss.init_scan_state(gray[0], depth[0], intr, cfg, device="cpu")
    final, out = ss.slam_scan(st, gray[1:], depth[1:], intr, cfg, **kw)
    poses = np.concatenate([n(final.m.kf_pose[:1]),
                            ss.compose_trajectory(final, out)])
    return final, out, poses


def test_slam_scan_matches_the_host_loop(arc):
    gray, depth, intr, gt = arc
    final, out, poses = _full_scan(gray, depth, intr)
    slam = tslam.Slam(CFG, intr, device="cpu")
    for i in range(gray.shape[0]):
        slam.process_frame(gray[i], depth[i])
    o = slam.result()
    assert int(final.num_loops) == o.num_loops
    assert int(final.m.num_kf) == o.num_keyframes >= 5
    assert int(final.num_relocs) == o.num_relocs
    np.testing.assert_array_equal(n(out.tracked), o.tracked[1:])
    # the same ops in the same order; the frame-relative pose is formed on
    # the host in one and on the device in the other: 1e-3
    close(poses, o.poses, rtol=0, atol=1e-3)
    assert int(out.is_kf.sum()) == o.num_keyframes - 1
    assert float(j_ate(jnp.asarray(poses), jnp.asarray(gt)).rmse) < 0.05
    assert out.T_rel.shape == (20, 4, 4) and out.ref_uid.dtype == torch.int32
    assert int(final.frame_idx) == 21


@pytest.mark.parametrize("n_frames,reports", [(21, 4), (18, 3)])
def test_chunked_slam_matches_full_scan(arc, n_frames, reports):
    """A whole number of chunks, and a tail of 2 after 3 chunks of 5: the
    same state and the same poses as one scan over the frames."""
    gray, depth, intr, _ = (a[:n_frames] if a.ndim == 3 else a for a in arc)
    ch = ss.ChunkedSlam(CFG, intr, chunk_size=5, device="cpu")
    outs = [ch.process_frame(gray[i], depth[i]) for i in range(n_frames)]
    assert sum(o is not None for o in outs) == reports
    tail = ch.flush()
    assert (tail is None) == (n_frames == 21)
    if tail is not None:
        assert tail.T_rel.shape[0] == 2
    poses_ch = ch.result()
    assert poses_ch.shape == (n_frames, 4, 4)
    final, _, poses_full = _full_scan(gray, depth, intr)
    for name in ("num_kf", "num_lm", "num_obs"):
        assert int(getattr(ch.state.m, name)) == int(getattr(final.m, name))
    assert int(ch.state.frame_idx) == int(final.frame_idx) == n_frames
    close(poses_ch, poses_full, rtol=0, atol=1e-5)
    assert ch.tracked().shape == (n_frames,) and ch.tracked().all()


def test_padding_frames_are_inert(arc):
    """live=False rows change nothing and draw nothing: the live frames give
    the poses of the unpadded scan, and a padding row repeats the carried
    pose, untracked."""
    gray, depth, intr, _ = arc
    _, out_ref, poses_ref = _full_scan(gray[:10], depth[:10], intr)
    live = np.ones(12, bool)
    live[[3, 4, 11]] = False
    # the nine live rows are frames 1..9 in order; a padding row repeats frame 0
    src = np.where(live, np.cumsum(live), 0)
    st = ss.init_scan_state(gray[0], depth[0], intr, CFG, device="cpu")
    final, out = ss.slam_scan(st, gray[src], depth[src], intr, CFG,
                              live=torch.from_numpy(live))
    assert int(final.frame_idx) == 10
    assert torch.equal(out.T_w_emit[live], out_ref.T_w_emit)
    assert not out.tracked[~live].any() and not out.is_kf[~live].any()
    assert torch.equal(out.T_w_emit[3], out.T_w_emit[2])
    assert torch.equal(out.T_w_emit[4], out.T_w_emit[2])
    close(ss.compose_trajectory(final, out)[live], poses_ref[1:], atol=1e-6)


def test_scan_takes_the_gyro_prior_and_state_round_trips(arc):
    gray, depth, intr, gt = arc
    packets = imu_from_poses(gt[:8])
    ch = ss.ChunkedSlam(CFG, intr, chunk_size=3, device="cpu")
    slam = tslam.Slam(CFG, intr, device="cpu")
    for i in range(8):
        packet = tuple(p[i] for p in packets)
        ch.process_frame(gray[i], depth[i], imu_packet=packet)
        slam.process_frame(gray[i], depth[i], imu_packet=packet)
    ch.flush()
    close(ch.result(), slam.result().poses, rtol=0, atol=1e-3)
    close(ch.imu_state.theta, slam.attitude, rtol=0, atol=0)
    fields = convert.scan_state_to_numpy(ch.state)
    back = convert.scan_state_from_numpy(fields, device="cpu")
    for a, b in zip(back.m, ch.state.m):
        assert torch.equal(a, b)
    assert int(back.frame_idx) == 8 and torch.equal(back.T_wc, ch.state.T_wc)
    assert back.ref_slot.dtype == torch.int32


def test_empty_scan_stereo_and_mesh(arc):
    gray, depth, intr, _ = arc
    st = ss.init_scan_state(gray[0], depth[0], intr, CFG, device="cpu")
    final, out = ss.slam_scan(st, gray[:0], depth[:0], intr, CFG)
    assert out.T_rel.shape == (0, 4, 4) and final is st
    assert ss.compose_trajectory(final, out).shape == (0, 4, 4)
    # a mesh whose size does not divide the landmark capacity is refused
    three = types.SimpleNamespace(size=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide the mesh"):
        ss.slam_scan(st, gray[1:2], depth[1:2], intr, CFG, mesh=three)
    with pytest.raises(ValueError, match="must divide the mesh"):
        ss.ChunkedSlam(CFG, intr, mesh=three)
    # stereo: the second channel is the right image (here the next frame
    # of the arc, which is what a camera 2 cm ahead sees); one frame runs
    scfg = CFG.replace(stereo=StereoConfig(baseline=0.11),
                       tracking=TrackingConfig(max_depth=80.0))
    sst = ss.init_scan_state(gray[0], gray[1], intr, scfg, device="cpu")
    sfinal, sout = ss.slam_scan(sst, gray[1:2], gray[2:3], intr, scfg)
    assert int(sfinal.frame_idx) == 2 and sout.T_rel.shape == (1, 4, 4)
    assert torch.isfinite(sout.T_w_emit).all()
    assert ss.ChunkedSlam(CFG, intr, device="cpu").result().shape == (0, 4, 4)


def test_loop_closes_on_a_small_lap_in_both_packages():
    """A 60-frame lap with a 16-frame overshoot at 120x160: the revisit closes
    a loop in the JAX package and in the port, fed the same features.  The
    two draw different RANSAC samples, so poses are not compared: keyframes,
    the closure and the accuracy of both are."""
    lap, n_frames = 60, 76
    kw = dict(max_keyframes=64, max_landmarks=2048, max_obs=8192, kf_min_gap=2,
              kf_max_gap=4, window_size=4)
    jcfg = JSystemConfig(
        frontend=JFrontendConfig(height=H, width=W, num_levels=2,
                                 max_keypoints=256),
        tracking=JTrackingConfig(match_window=16.0), map=JMapConfig(**kw))
    tcfg = SystemConfig(
        frontend=FrontendConfig(height=H, width=W, num_levels=2,
                                max_keypoints=256),
        tracking=TrackingConfig(match_window=16.0), map=MapConfig(**kw))
    seq = j_lap_sequence(n_frames=n_frames, shape=(H, W), lap_frames=lap)
    jsl = jslam.Slam(jcfg, seq.intrinsics)
    tsl = tslam.Slam(tcfg, np.asarray(seq.intrinsics), device="cpu")
    for i in range(n_frames):
        feats = jsl.features(seq.gray[i], seq.depth[i])
        jsl.process_features(feats)
        tsl.process_features(
            convert.features_from_numpy(jax_features_to_numpy(feats), "cpu"))
    jo, to = jsl.result(), tsl.result()
    assert jo.num_loops >= 1 and to.num_loops >= 1
    assert int(tsl.m.num_loop) == to.num_loops
    assert abs(to.num_keyframes - jo.num_keyframes) <= 2
    assert abs(to.tracked.mean() - jo.tracked.mean()) <= 0.05
    j_rmse = float(j_ate(jnp.asarray(jo.poses), seq.poses).rmse)
    t_rmse = float(j_ate(jnp.asarray(to.poses), seq.poses).rmse)
    assert j_rmse < 0.35 and t_rmse < 0.35, (j_rmse, t_rmse)
