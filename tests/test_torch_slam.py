"""The SLAM scheduler of the PyTorch port vs the JAX package (CPU).

Step by step with the JAX package's state carried across: at every frame of a
short run the port's `track_and_associate` gets the JAX `Slam`'s features,
map, pose and motion model through `convert` and the JAX package's own RANSAC
samples, and at every keyframe the port's `keyframe_update` (insert + local BA
+ loop decision + closure + compaction) must leave the map the JAX `Slam`
leaves.  Then both systems run free on the same frames.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
from jetracer_orbslam2_tpu.config import MapConfig as JMapConfig
from jetracer_orbslam2_tpu.config import SystemConfig as JSystemConfig
from jetracer_orbslam2_tpu.evaluation import ate as j_ate
from jetracer_orbslam2_tpu.io.synthetic import generate_sequence as j_generate_sequence
from jetracer_orbslam2_tpu.io.synthetic import imu_from_poses as j_imu_from_poses
from jetracer_orbslam2_tpu.models import slam as jslam
from jetracer_orbslam2_tpu.models.backend import loop as jloop
from jetracer_orbslam2_tpu.ops import geometry as jgeo
from jetracer_orbslam2_tpu.ops import match as jmatch

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import FrontendConfig, MapConfig, SystemConfig
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models.backend import map as tmap

from _torch_port_util import (
    assert_maps_equal, jax_features_to_numpy, jax_map_from_numpy, n, t)

close = np.testing.assert_allclose

H, W, N_FRAMES = 120, 160, 16
MAP = dict(max_keyframes=16, max_landmarks=2048, max_obs=8192, kf_min_gap=2,
           kf_max_gap=4, window_size=4)
JCFG = JSystemConfig(
    frontend=JFrontendConfig(height=H, width=W, num_levels=2, max_keypoints=256),
    map=JMapConfig(**MAP))
TCFG = SystemConfig(
    frontend=FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=256),
    map=MapConfig(**MAP))
# frames whose tracker gets the gyro's rotation instead of the motion model's
IMU_FRAMES = (3, 4, 9)


@pytest.fixture(scope="module")
def run():
    seq = j_generate_sequence(n_frames=N_FRAMES, shape=(H, W))
    slam = jslam.Slam(JCFG, seq.intrinsics)
    feats = [slam.features(seq.gray[i], seq.depth[i]) for i in range(N_FRAMES)]
    packets = j_imu_from_poses(seq.poses)
    return seq, feats, packets


def _jax_samples(key, weights, iters):
    logits = jnp.log(jnp.maximum(jnp.asarray(weights, jnp.float32), 1e-20))
    return np.asarray(jax.random.categorical(key, logits, shape=(iters, 3)))


def _tracker_samples(prev, curr, velocity, intr, key):
    """The draw the JAX tracker's RANSAC makes for this pair of frames."""
    tc = JCFG.tracking
    pts = jgeo.transform_points(jgeo.pose_inverse(velocity), prev.points[None])[0]
    m = jmatch.match(prev.desc, curr.desc, prev.has_point, curr.has_point,
                     xy_a_pred=jgeo.project(pts, intr), xy_b=curr.xy,
                     window=tc.match_window, max_hamming=tc.match_max_hamming,
                     ratio=tc.match_ratio)
    pair_ok = np.asarray(m.valid & jnp.take(curr.has_point, m.idx))
    return _jax_samples(key, pair_ok, tc.ransac_iters)


def _loop_samples(jm, slot, key):
    """The draws `retrieve_and_verify` makes at keyframe `slot` of map `jm`
    (they depend on descriptors and depth flags only, which inserts copy)."""
    lc = JCFG.loop
    cands = jloop.retrieve_topn(jm, jnp.int32(slot), lc.min_sim, lc.min_kf_gap,
                                lc.topn)
    keys = jax.random.split(key, lc.topn)
    out = []
    for c in range(lc.topn):
        b = int(cands.kf_idx[c])
        res = jmatch.match(jm.kf_desc[slot], jm.kf_desc[b], jm.kf_has_point[slot],
                           jm.kf_has_point[b], xy_a_pred=None, xy_b=None,
                           window=0.0, max_hamming=80.0, mutual=True)
        w = np.asarray(res.valid & jm.kf_has_point[b][res.idx])
        out.append(_jax_samples(keys[c], w, 512))
    return np.stack(out)


def _tfeats(jf):
    return convert.features_from_numpy(jax_features_to_numpy(jf), "cpu")


def test_configs_describe_the_same_system():
    assert JCFG.map == JMapConfig(**TCFG.map.__dict__)
    assert JCFG.loop.__dict__ == TCFG.loop.__dict__
    assert JCFG.reloc.__dict__ == TCFG.reloc.__dict__
    assert JCFG.tracking.__dict__ == TCFG.tracking.__dict__


def test_step_by_step_with_the_jax_state_carried_across(run):
    seq, feats, packets = run
    intr = np.asarray(seq.intrinsics)
    slam = jslam.Slam(JCFG, seq.intrinsics)
    slam.process_features(feats[0])
    keyframes = 0
    for i in range(1, N_FRAMES):
        # the JAX scheduler's state before the frame
        prev, m0, T0, vel0 = slam.prev, slam.m, slam.T_wc, slam.velocity
        fsk, lp_uid, lp_cons = (slam.frames_since_kf, slam._loop_prev_uid,
                                slam._loop_consist)
        packet = tuple(p[i] for p in packets) if i in IMU_FRAMES else None
        dw = np.zeros(3, np.float32)
        if packet is not None:
            _, dw = jslam.imu_mod.process_packet_with_delta(
                slam.imu_state, *(jnp.asarray(p) for p in packet))
            dw = np.asarray(dw)
        key = jax.random.fold_in(slam.base_key, i)
        jres, j_idx, j_ok, jrep = jslam.track_and_associate(
            prev, feats[i], m0, T0, vel0, jnp.asarray(dw),
            jnp.asarray(packet is not None), jnp.int32(fsk), seq.intrinsics,
            key, JCFG)
        vel_used = vel0 if packet is None else jgeo.pose_from_rt(
            jgeo.so3_exp(jnp.asarray(dw)), vel0[:3, 3])
        idx = _tracker_samples(prev, feats[i], vel_used, seq.intrinsics, key)

        tm0 = convert.map_state_from_numpy(m0, "cpu")
        tres, t_idx, t_ok, trep = tslam.track_and_associate(
            _tfeats(prev), _tfeats(feats[i]), tm0, t(n(T0)), t(n(vel0)), dw,
            packet is not None, fsk, t(intr), None, TCFG, sample_idx=t(idx),
            device="cpu")
        assert bool(trep.need_kf) == bool(jrep.need_kf), i
        assert bool(trep.tracked_ok) == bool(jrep.tracked_ok), i
        assert int(trep.num_assoc) == int(jrep.num_assoc), i
        assert int(trep.num_matches) == int(jrep.num_matches), i
        np.testing.assert_array_equal(n(t_ok), n(j_ok))
        np.testing.assert_array_equal(n(t_idx)[n(t_ok)], n(j_idx)[n(j_ok)])
        # RANSAC consensus + two Kabsch fits + two 5-step polishes: 1e-4
        close(n(trep.T_wc), n(jrep.T_wc), rtol=0, atol=1e-4)
        close(n(tres.velocity), n(jres.velocity), rtol=0, atol=1e-4)
        close(n(trep.packed), n(jrep.packed), rtol=0, atol=1e-4)
        report = convert.frame_report_from_numpy(jrep, "cpu")
        assert torch.equal(report.need_kf, trep.need_kf)

        # the JAX scheduler takes the frame (same key, same results)
        slam.process_features(feats[i], imu_packet=packet)
        if not bool(jrep.need_kf):
            continue
        keyframes += 1
        # the port's keyframe branch from the same start: the JAX map before
        # the frame, the JAX tracked pose and associations
        inserted, slot = tmap.insert_keyframe(
            tm0, _tfeats(feats[i]), t(n(jrep.T_wc)), i,
            t(n(feats[i].has_point & ~j_ok)), t(n(j_idx)), t(n(j_ok)),
            device="cpu")
        lkey = jax.random.fold_in(slam.base_key, 10_000 + i)
        loop_idx = _loop_samples(
            jax_map_from_numpy(convert.map_state_to_numpy(inserted)),
            int(slot), lkey)
        up = tslam.keyframe_update(
            tm0, _tfeats(feats[i]), t(n(jrep.T_wc)), i, t(n(j_idx)), t(n(j_ok)),
            t(intr), TCFG, None, lp_uid, lp_cons, sample_idx=t(loop_idx),
            device="cpu")
        # the tolerances of tests/test_torch_map.py after a windowed BA
        assert_maps_equal(up.m, slam.m,
                          float_atol={"kf_pose": 1e-4, "lm_pos": 1e-3})
        assert (int(up.loop_prev_uid), int(up.loop_consist)) == (
            slam._loop_prev_uid, slam._loop_consist), i
        close(n(up.T_wc), n(slam.T_wc), rtol=0, atol=1e-4)
        assert int(up.slot) == int(slam.m.num_kf) - 1
        assert not up.looped
    assert 3 <= keyframes <= 8
    assert slam.num_compactions == 0


def test_free_running_slam_matches(run):
    """Both systems free on the same frames (the port with its own front-end
    and its own RANSAC stream): same keyframes, ATE of both under the arc's
    5 cm gate and within 1 cm of each other."""
    seq, _, _ = run
    gray, depth = np.asarray(seq.gray), np.asarray(seq.depth)
    jsl = jslam.Slam(JCFG, seq.intrinsics)
    tsl = tslam.Slam(TCFG, np.asarray(seq.intrinsics), device="cpu")
    for i in range(N_FRAMES):
        jsl.process_frame(seq.gray[i], seq.depth[i])
        rep = tsl.process_frame(gray[i], depth[i])
        assert (rep is None) == (i == 0)
    jo, to = jsl.result(), tsl.result()
    assert to.num_keyframes == jo.num_keyframes
    assert to.num_loops == jo.num_loops == 0 and to.num_relocs == 0
    assert to.tracked.all() and jo.tracked.all()
    assert to.poses.shape == (N_FRAMES, 4, 4) and to.poses.dtype == np.float32
    j_rmse = float(j_ate(jnp.asarray(jo.poses), seq.poses).rmse)
    t_rmse = float(j_ate(jnp.asarray(to.poses), seq.poses).rmse)
    assert j_rmse < 0.05 and t_rmse < 0.05
    assert abs(j_rmse - t_rmse) < 0.01
    assert abs(to.num_landmarks - jo.num_landmarks) <= 0.05 * jo.num_landmarks


def test_slam_folds_imu_packets_and_reports_attitude(run):
    seq, feats, packets = run
    jsl = jslam.Slam(JCFG, seq.intrinsics)
    tsl = tslam.Slam(TCFG, np.asarray(seq.intrinsics), device="cpu")
    for i in range(6):
        packet = tuple(p[i] for p in packets)
        jsl.process_features(feats[i], imu_packet=packet)
        tsl.process_features(_tfeats(feats[i]), imu_packet=packet)
    close(tsl.attitude, jsl.attitude, rtol=0, atol=1e-6)
    assert tsl.tracked == jsl.tracked
    # the prior is consumed by the frame that follows the packet
    assert tsl._imu_delta_ok is False


def test_relocalize_reposes_a_lost_frame(run):
    """A frame whose pose estimate is lost is re-posed against the keyframe
    store from retrieval + RANSAC alone."""
    seq, feats, _ = run
    tsl = tslam.Slam(TCFG, np.asarray(seq.intrinsics), seed=1, device="cpu")
    for i in range(8):
        tsl.process_features(_tfeats(feats[i]))
    T_before = tsl.T_wc.clone()
    tsl.T_wc = tsl.T_wc @ t(np.float32(
        [[1, 0, 0, 0.7], [0, 1, 0, 0], [0, 0, 1, -0.4], [0, 0, 0, 1]]))
    assert tsl._try_relocalize(_tfeats(feats[7]))
    assert tsl.num_relocs == 1 and tsl.lost_streak == 0
    close(n(tsl.T_wc), n(T_before), rtol=0, atol=3e-2)
    assert torch.equal(tsl.velocity, torch.eye(4))
    blank = _tfeats(feats[7])._replace(
        has_point=torch.zeros(256, dtype=torch.bool))
    assert not tsl._try_relocalize(blank)


def test_mesh_is_refused():
    """A mesh whose size does not divide the map's landmark capacity, or that
    lives on another device, is refused when the system is made."""
    three = types.SimpleNamespace(size=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide the mesh"):
        tslam.Slam(TCFG, np.float32([100, 100, 80, 60]), mesh=three,
                   device="cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        tslam.Slam(TCFG, np.float32([100, 100, 80, 60]),
                   mesh=types.SimpleNamespace(size=1, rank=0,
                                              device=torch.device("meta")),
                   device="cpu")
