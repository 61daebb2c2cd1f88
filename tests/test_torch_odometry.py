"""The ported odometry path as a whole vs the JAX package (CPU): front-end on a
rendered sequence, the odometry scan, chunked streaming, the renderer, the CLI.

A 12-frame 120x160 sequence is rendered by the JAX generator and quantized to
8 bits (a camera's output, and what makes the first two pyramid levels exact
in f32); both implementations get the same frames.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
from jetracer_orbslam2_tpu.config import TrackingConfig as JTrackingConfig
from jetracer_orbslam2_tpu.evaluation import ate as j_ate
from jetracer_orbslam2_tpu.io import synthetic as jsyn
from jetracer_orbslam2_tpu.models import odometry as jodom
from jetracer_orbslam2_tpu.models.frontend import frontend_gray_depth as j_frontend

from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.config import FrontendConfig, TrackingConfig
from jetracer_orbslam2_torch.convert import (
    desc_to_numpy, features_from_numpy, features_to_numpy,
    odom_state_from_numpy, odom_state_to_numpy)
from jetracer_orbslam2_torch.evaluation import ate, rpe, rpe_drift, rpe_drift_median
from jetracer_orbslam2_torch.io import synthetic as tsyn
from jetracer_orbslam2_torch.models import odometry as todom
from jetracer_orbslam2_torch.models.frontend import frontend_gray_depth, frontend_rgbd
from jetracer_orbslam2_torch.ops.orb import angle_bins

from _torch_port_util import FEATURE_FIELDS, jax_features_to_numpy, n, t

close = np.testing.assert_allclose

N, H, W = 12, 120, 160
_CFG = dict(height=H, width=W, num_levels=2, max_keypoints=256)


@pytest.fixture(scope="module")
def sequence():
    seq = jsyn.generate_sequence(n_frames=N, shape=(H, W))
    return {
        "gray": np.round(np.asarray(seq.gray)).astype(np.float32),
        "depth": np.asarray(seq.depth),
        "poses": np.asarray(seq.poses),
        "intr": np.asarray(seq.intrinsics),
    }


def test_frontend_gray_depth_matches(sequence):
    s = sequence
    fj, ft = JFrontendConfig(**_CFG), FrontendConfig(**_CFG)
    assert fj.level_shapes == ft.level_shapes and fj.total_cells == ft.total_cells
    n_valid = n_desc_equal = 0
    for i in (0, 5):
        ref = jax_features_to_numpy(j_frontend(
            jnp.asarray(s["gray"][i]), jnp.asarray(s["depth"][i]),
            jnp.asarray(s["intr"]), fj))
        got = features_to_numpy(frontend_gray_depth(
            t(s["gray"][i]), t(s["depth"][i]), t(s["intr"]), ft, device="cpu"))
        for name in ("xy", "level", "score", "valid", "has_point"):
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        # (x - cx) / fx * z, see test_torch_geometry: atol 1e-5 m
        close(got["points"], ref["points"], rtol=0, atol=1e-5)
        valid = ref["valid"]
        assert valid.sum() > 40
        # angles of valid keypoints: XLA's f32 moment sums vs f64-accumulated
        d = np.abs(got["angle"] - ref["angle"])[valid]
        assert np.minimum(d, 2 * np.pi - d).max() < 1e-4
        same = (got["desc"] == ref["desc"]).all(-1)
        # a descriptor may differ only where the two angles fall in different
        # rotation bins (an angle within rounding of a bin edge)
        bins_t = n(angle_bins(t(got["angle"]), 32))
        bins_j = n(angle_bins(t(ref["angle"]), 32))
        assert (same | (bins_t != bins_j))[valid].all()
        n_valid += int(valid.sum())
        n_desc_equal += int(same[valid].sum())
    assert n_desc_equal >= 0.99 * n_valid


def test_frontend_two_threshold_merge_matches(sequence):
    s = sequence
    cfg = dict(_CFG, fast_threshold=40.0, fast_min_threshold=7.0)
    ref = jax_features_to_numpy(j_frontend(
        jnp.asarray(s["gray"][0]), jnp.asarray(s["depth"][0]),
        jnp.asarray(s["intr"]), JFrontendConfig(**cfg)))
    got = features_to_numpy(frontend_gray_depth(
        t(s["gray"][0]), t(s["depth"][0]), t(s["intr"]), FrontendConfig(**cfg),
        device="cpu"))
    for name in ("xy", "level", "score", "valid", "has_point"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    one = features_to_numpy(frontend_gray_depth(
        t(s["gray"][0]), t(s["depth"][0]), t(s["intr"]),
        FrontendConfig(**dict(cfg, fast_min_threshold=0.0)), device="cpu"))
    assert got["valid"].sum() > one["valid"].sum()      # the low pass adds cells


def test_frontend_rgbd_and_unported_depth_alignment(sequence):
    s = sequence
    g = s["gray"][0]
    rgb = np.stack([g, g, g], -1).astype(np.uint8)
    a = frontend_rgbd(t(rgb), t(s["depth"][0]), t(s["intr"]), FrontendConfig(**_CFG),
                      device="cpu")
    assert int(a.valid.sum()) > 40 and a.desc.dtype == torch.int32
    # an unregistered depth camera: the depth map is re-rendered into the
    # colour frame first, in both packages
    calib = dict(depth_intrinsics=(152.0, 152.0, 80.5, 59.0),
                 T_color_depth=(1.0, 0.0, 0.0, 0.02, 0.0, 1.0, 0.0, 0.0,
                                0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0))
    ref = jax_features_to_numpy(j_frontend(
        jnp.asarray(g), jnp.asarray(s["depth"][0]), jnp.asarray(s["intr"]),
        JFrontendConfig(**_CFG, **calib)))
    got = features_to_numpy(frontend_gray_depth(
        t(g), t(s["depth"][0]), t(s["intr"]), FrontendConfig(**_CFG, **calib),
        device="cpu"))
    for name in ("xy", "level", "score", "valid", "has_point"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    close(got["points"], ref["points"], rtol=0, atol=1e-5)
    assert ref["has_point"].sum() > 40


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_odometry_scan_matches_jax(sequence):
    s = sequence
    fj, tj = JFrontendConfig(**_CFG), JTrackingConfig()
    ft, tt = FrontendConfig(**_CFG), TrackingConfig()
    st_j = jodom.init_state(jnp.asarray(s["gray"][0]), jnp.asarray(s["depth"][0]),
                            jnp.asarray(s["intr"]), fj, tj)
    _, poses_j, ok_j = jodom.odometry_scan(
        st_j, jnp.asarray(s["gray"][1:]), jnp.asarray(s["depth"][1:]),
        jnp.asarray(s["intr"]), fj, tj)
    st_t = todom.init_state(s["gray"][0], s["depth"][0], s["intr"], ft, tt,
                            device="cpu")
    final, poses_t, ok_t = todom.odometry_scan(
        st_t, s["gray"][1:], s["depth"][1:], s["intr"], ft, tt)
    poses_j, poses_t = n(poses_j), n(poses_t)
    np.testing.assert_array_equal(n(ok_t), n(ok_j))
    assert n(ok_t).all()
    assert int(final.frame_idx) == N - 1
    # each side draws its own RANSAC samples, and both polish the consensus
    # they reach by the same Gauss-Newton: every pose within 5 mm and 0.1 deg
    for a, b in zip(poses_t, poses_j):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 5e-3
        assert _rot_deg(a[:3, :3], b[:3, :3]) < 0.1
    eye = np.eye(4, dtype=np.float32)[None]
    gt = s["poses"]
    full_t = np.concatenate([eye, poses_t])
    full_j = np.concatenate([eye, poses_j])
    ate_t = float(ate(t(full_t), t(gt)).rmse)
    ate_j = float(j_ate(jnp.asarray(full_j), jnp.asarray(gt)).rmse)
    assert ate_t < 0.05 and ate_j < 0.05
    # the port's metrics agree with the JAX package's on the same trajectory
    r_t = ate(t(full_j), t(gt))
    r_j = j_ate(jnp.asarray(full_j), jnp.asarray(gt))
    for name in ("rmse", "mean", "median", "max"):
        close(float(getattr(r_t, name)), float(getattr(r_j, name)), rtol=0, atol=1e-6)
    from jetracer_orbslam2_tpu.evaluation import rpe as j_rpe, rpe_drift as j_drift
    for f_t, f_j, d in ((rpe, j_rpe, 1), (rpe_drift, j_drift, 5)):
        a = f_t(t(full_j), t(gt), delta=d)
        b = f_j(jnp.asarray(full_j), jnp.asarray(gt), delta=d)
        # translation part exact to 1e-6; the angle comes from arccos near 1,
        # where an ulp of the trace is ~3e-4 rad
        close(float(a[0]), float(b[0]), rtol=0, atol=1e-6)
        close(float(a[1]), float(b[1]), rtol=0, atol=2e-3)


@pytest.mark.parametrize("delta", [4, 5])
def test_rpe_drift_median_matches_jax(delta):
    """The median drift ratios against the JAX package, rtol 1e-5, over 20
    (even: the two middle values are averaged) and 19 segments.  The
    estimate is the truth rotated by about 0.15 rad a frame, so each
    segment's angle error stays away from 0, where arccos of the trace turns
    an ulp into 3e-4 rad."""
    from jetracer_orbslam2_tpu.evaluation import rpe_drift_median as j_median
    from jetracer_orbslam2_tpu.ops import geometry as jgeo

    rng = np.random.default_rng(11)
    steps = np.concatenate([rng.normal(0, 0.02, (24, 3)),
                            rng.normal([0.0, 0.0, 0.05], 0.01, (24, 3))], 1)
    gt = np.array(jgeo.se3_exp(jnp.asarray(steps, jnp.float32)))
    for i in range(1, 24):
        gt[i] = gt[i - 1] @ gt[i]
    noise = np.concatenate([rng.normal(0, 0.08, (24, 3)),
                            rng.normal(0, 0.15, (24, 3))], 1)
    est = gt @ np.asarray(jgeo.se3_exp(jnp.asarray(noise, jnp.float32)))
    gt, est = gt.astype(np.float32), est.astype(np.float32)
    got = rpe_drift_median(t(est), t(gt), delta=delta)
    want = j_median(jnp.asarray(est), jnp.asarray(gt), delta=delta)
    for g, w in zip(got, want):
        close(float(g), float(w), rtol=1e-5, atol=0)
        assert float(g) > 0.1


@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_equals_whole_scan(sequence, chunk):
    s = sequence
    ft, tt = FrontendConfig(**_CFG), TrackingConfig()
    st = todom.init_state(s["gray"][0], s["depth"][0], s["intr"], ft, tt,
                          seed=3, device="cpu")
    _, poses, ok = todom.odometry_scan(st, s["gray"][1:], s["depth"][1:],
                                       s["intr"], ft, tt)
    ch = todom.ChunkedOdometry(s["intr"], ft, tt, chunk_size=chunk, seed=3,
                               device="cpu")
    for i in range(N):                      # 11 tracked frames: a ragged tail
        ch.process_frame(s["gray"][i], s["depth"][i])
    ch.flush()
    poses_c, ok_c = ch.result()
    assert poses_c.shape == (N, 4, 4)
    np.testing.assert_array_equal(poses_c[1:], n(poses))
    np.testing.assert_array_equal(ok_c[1:], n(ok))
    np.testing.assert_array_equal(poses_c[0], np.eye(4, dtype=np.float32))


def test_scan_live_mask_skips_padding(sequence):
    s = sequence
    ft, tt = FrontendConfig(**_CFG), TrackingConfig()

    def start():
        return todom.init_state(s["gray"][0], s["depth"][0], s["intr"], ft, tt,
                                seed=1, device="cpu")

    _, poses, ok = todom.odometry_scan(start(), s["gray"][1:4], s["depth"][1:4],
                                       s["intr"], ft, tt)
    g = np.concatenate([s["gray"][1:4], s["gray"][3:4], s["gray"][3:4]])
    d = np.concatenate([s["depth"][1:4], s["depth"][3:4], s["depth"][3:4]])
    final, poses_p, ok_p = todom.odometry_scan(
        start(), g, d, s["intr"], ft, tt, live=np.arange(5) < 3)
    np.testing.assert_array_equal(n(poses_p)[:3], n(poses))
    np.testing.assert_array_equal(n(ok_p), [True, True, True, False, False])
    np.testing.assert_array_equal(n(poses_p)[3], n(poses)[2])   # carried pose
    assert int(final.frame_idx) == 3


def test_state_round_trips_through_numpy(sequence):
    s = sequence
    ft, tt = FrontendConfig(**_CFG), TrackingConfig()
    st = todom.init_state(s["gray"][0], s["depth"][0], s["intr"], ft, tt,
                          seed=5, device="cpu")
    st, _, _ = todom.odometry_scan(st, s["gray"][1:3], s["depth"][1:3],
                                   s["intr"], ft, tt)
    d = odom_state_to_numpy(st)
    assert d["prev"]["desc"].dtype == np.uint32 and d["frame_idx"] == 2
    back = odom_state_from_numpy(d["T_wc"], d["velocity"], d["prev"],
                                 frame_idx=d["frame_idx"], seed=5, device="cpu")
    for name in FEATURE_FIELDS:
        assert torch.equal(getattr(back.prev, name), getattr(st.prev, name)), name
    assert torch.equal(back.T_wc, st.T_wc) and int(back.frame_idx) == 2
    # a JAX feature set crosses over with its descriptor bits intact
    fj = j_frontend(jnp.asarray(s["gray"][0]), jnp.asarray(s["depth"][0]),
                    jnp.asarray(s["intr"]), JFrontendConfig(**_CFG))
    ref = jax_features_to_numpy(fj)
    np.testing.assert_array_equal(
        desc_to_numpy(features_from_numpy(ref, "cpu").desc), ref["desc"])


def test_render_frame_matches_with_shared_textures():
    textures = tsyn.make_textures(seed=4)
    assert textures.shape == (tsyn.NUM_PLANES, 256, 256) == (len(jsyn._PLANES), 256, 256)
    poses = n(jsyn.smooth_trajectory(9))
    close(n(tsyn.smooth_trajectory(9)), poses, rtol=0, atol=1e-6)
    intr = np.float32([0.9 * W, 0.9 * W, (W - 1) / 2.0, (H - 1) / 2.0])
    for i in (0, 8):
        g_j, d_j = jsyn.render_frame(jnp.asarray(poses[i]), jnp.asarray(intr),
                                     jnp.asarray(textures), (H, W))
        g_t, d_t = tsyn.render_frame(t(poses[i]), t(intr), t(textures), (H, W))
        close(n(d_t), n(d_j), rtol=0, atol=1e-5)
        close(n(g_t), n(g_j), rtol=0, atol=1e-3)          # grey levels of 255
        assert n(g_j).std() > 20


def test_generate_sequence_is_trackable():
    seq = tsyn.generate_sequence(n_frames=6, shape=(H, W), seed=1, device="cpu")
    assert tuple(seq.gray.shape) == (6, H, W) and seq.gray.device.type == "cpu"
    assert float(seq.depth.min()) > 0.1
    again = tsyn.generate_sequence(n_frames=2, shape=(H, W), seed=1, device="cpu")
    assert torch.equal(again.gray, seq.gray[:2])           # seeded
    ft, tt = FrontendConfig(**_CFG), TrackingConfig()
    st = todom.init_state(seq.gray[0], seq.depth[0], seq.intrinsics, ft, tt,
                          device="cpu")
    _, poses, ok = todom.odometry_scan(st, seq.gray[1:], seq.depth[1:],
                                       seq.intrinsics, ft, tt)
    assert bool(ok.all())
    full = torch.cat([torch.eye(4)[None], poses])
    assert float(ate(full, seq.poses).rmse) < 0.05


@pytest.mark.parametrize("extra", [[], ["--chunked", "3"]])
def test_cli_odometry_prints_one_json_line(capsys, extra):
    rc = trun.main(["--synthetic", "8", "--mode", "odometry", "--device", "cpu",
                    "--levels", "2", "--max-keypoints", "256", "--json"] + extra)
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert report["frames"] == 8 and report["device"] == "cpu"
    assert report["tracked_frac"] == 1.0
    assert report["ate_rmse_m"] < 0.05
    assert report["mode"] == ("odometry-chunked3" if extra else "odometry")
