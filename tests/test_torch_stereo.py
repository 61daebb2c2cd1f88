"""The ported stereo path vs the JAX package (CPU): the stereo generators, the
subpixel SAD polish, `frontend_stereo` (pre-rectified, and distorted with a
tilted right camera) and the stereo `slam_scan` as a whole.

Stereo pairs are rendered by the JAX generator and quantized to 8 bits (a
camera's output); both implementations get the same frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu import config as jcfg
from jetracer_orbslam2_tpu.io import datasets as jds
from jetracer_orbslam2_tpu.io import synthetic as jsyn
from jetracer_orbslam2_tpu.models import slam_scan as jss
from jetracer_orbslam2_tpu.models import stereo as jst
from jetracer_orbslam2_tpu.models.frontend import extract_features as j_extract
from jetracer_orbslam2_tpu.ops import geometry as jgeo
from jetracer_orbslam2_tpu.ops import match as jmatch

from jetracer_orbslam2_torch import config as tcfg
from jetracer_orbslam2_torch.convert import features_to_numpy
from jetracer_orbslam2_torch.io import datasets as tds
from jetracer_orbslam2_torch.io import synthetic as tsyn
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models import slam_scan as tss
from jetracer_orbslam2_torch.models import stereo as tst
from jetracer_orbslam2_torch.models.frontend import extract_features as t_extract
from jetracer_orbslam2_torch.ops import fused_fast
from jetracer_orbslam2_torch.ops import geometry as tgeo
from jetracer_orbslam2_torch.ops.orb import angle_bins

from _torch_port_util import image_u8, jax_features_to_numpy, n, t

close = np.testing.assert_allclose

H, W = 120, 160
FE = dict(height=H, width=W, num_levels=2, max_keypoints=256)
DIST = (-0.25, 0.06, 5e-4, 5e-4, 0.0)
DIST_R = (-0.22, 0.05, -4e-4, 3e-4, 0.0)
ROT = (0.008, -0.015, 0.004)


def _jax_textures(seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(jsyn._PLANES))
    return np.asarray(jnp.stack([jsyn.make_texture(k) for k in keys]))


def _u8(a):
    return np.round(np.asarray(a)).astype(np.float32)


@pytest.fixture(scope="module")
def arc():
    seq = jsyn.generate_stereo_sequence(n_frames=12, shape=(H, W))
    return {"left": _u8(seq.left), "right": _u8(seq.right),
            "left_f": np.asarray(seq.left), "right_f": np.asarray(seq.right),
            "intr": np.asarray(seq.intrinsics), "poses": np.asarray(seq.poses)}


# the front-end parity tests: twice the width, so that enough keypoints
# have a disparity of several pixels
FE2 = dict(height=2 * H, width=2 * W, num_levels=3, max_keypoints=256)


@pytest.fixture(scope="module")
def pairs():
    seq = jsyn.generate_stereo_sequence(n_frames=7, shape=(2 * H, 2 * W))
    return {"left": _u8(seq.left), "right": _u8(seq.right),
            "intr": np.asarray(seq.intrinsics)}


@pytest.fixture(scope="module")
def distorted():
    """A distorted rig with a tilted right camera, and its calibration as
    each package's loader would derive it."""
    seq = jsyn.generate_stereo_sequence(n_frames=1, shape=(2 * H, 2 * W),
                                        dist_l=DIST, dist_r=DIST_R,
                                        right_rotation=ROT)
    shift = np.eye(4)
    shift[0, 3] = seq.baseline
    shift[:3, :3] = np.asarray(jgeo.so3_exp(jnp.asarray(ROT)))
    T_c1_c0 = np.linalg.inv(shift)
    return {"left": _u8(seq.left[0]), "right": _u8(seq.right[0]),
            "intr": np.asarray(seq.intrinsics), "T_c1_c0": T_c1_c0}


@pytest.mark.parametrize("kind", ["arc", "distorted", "lap"])
def test_stereo_generators_match_with_shared_textures(kind):
    tex = _jax_textures(3)
    if kind == "lap":
        kw = dict(n_frames=3, shape=(H, W), seed=3, lap_frames=8, baseline=0.2)
        ref = jsyn.generate_stereo_lap_sequence(**kw)
        got = tsyn.generate_stereo_lap_sequence(**kw, textures=tex, device="cpu")
    else:
        kw = dict(n_frames=3, shape=(H, W), seed=3)
        if kind == "distorted":
            kw.update(dist_l=DIST, dist_r=DIST_R, right_rotation=ROT)
        ref = jsyn.generate_stereo_sequence(**kw)
        got = tsyn.generate_stereo_sequence(**kw, textures=tex, device="cpu")
    close(n(got.poses), np.asarray(ref.poses), rtol=0, atol=1e-6)
    close(n(got.intrinsics), np.asarray(ref.intrinsics), rtol=0, atol=0)
    assert got.baseline == ref.baseline
    close(n(got.depth), np.asarray(ref.depth), rtol=0, atol=1e-5)
    for name in ("left", "right"):               # grey levels of 255
        diff = np.abs(n(getattr(got, name)) - np.asarray(getattr(ref, name)))
        if kind != "distorted":
            assert diff.max() <= 1e-3, (name, diff.max())
        else:
            # a distorted pixel's ray comes from 8 fixed-point steps of f32
            # polynomial arithmetic, which XLA contracts differently; texel
            # coordinates are the hit x 64, so at texture edges an ulp of
            # the ray shows as a few 1e-3 grey levels (on 1.0 % of the right
            # image's pixels, 0.2 % of the left's)
            assert (diff <= 1e-3).mean() >= 0.98, (name, (diff > 1e-3).mean())
            assert diff.max() <= 1e-2, (name, diff.max())
    assert np.asarray(ref.right).std() > 20
    assert got.left.shape == (3, H, W) and got.left.device.type == "cpu"


def _random_refine_inputs(rng, k=300):
    xl = rng.integers(0, W, k)
    yl = rng.integers(0, H, k)
    xr0 = xl - rng.integers(0, 24, k)
    yr = np.clip(yl + rng.integers(-1, 2, k), 0, H - 1)
    level = rng.integers(0, 3, k)
    return [a.astype(np.int32) for a in (xl, yl, xr0, yr, level)]


def test_refine_right_x_is_bit_exact_on_integer_images():
    left, right = image_u8((H, W), seed=1), image_u8((H, W), seed=2)
    # the right image a shifted copy of the left plus a little noise, so
    # minima are interior and a real share of keypoints is trusted
    right = np.clip(np.roll(left, -5, axis=1) + (right - 128) // 32, 0, 255)
    args = _random_refine_inputs(np.random.default_rng(0))
    xr_j, ok_j = jst._refine_right_x(jnp.asarray(left), jnp.asarray(right),
                                     *map(jnp.asarray, args))
    xr_t, ok_t = tst._refine_right_x(t(left), t(right), *map(t, args))
    np.testing.assert_array_equal(n(ok_t), np.asarray(ok_j))
    np.testing.assert_array_equal(n(xr_t), np.asarray(xr_j))
    assert xr_t.dtype == torch.float32
    assert 0.2 < np.asarray(ok_j).mean() < 1.0
    # _refine_disparity on the same images
    rng = np.random.default_rng(1)
    xy = np.stack([rng.integers(0, W, 300), rng.integers(0, H, 300)],
                  -1).astype(np.float32)
    disp0 = rng.uniform(0.5, 20.0, 300).astype(np.float32)
    d_j = jst._refine_disparity(jnp.asarray(left), jnp.asarray(right),
                                jnp.asarray(xy), jnp.asarray(disp0),
                                jnp.asarray(args[4]))
    d_t = tst._refine_disparity(t(left), t(right), t(xy), t(disp0), t(args[4]))
    np.testing.assert_array_equal(n(d_t), np.asarray(d_j))


def test_refine_disparity_on_rendered_frames(arc):
    """Unquantized renders: SAD sums may round differently, so >= 99 % of the
    refined disparities are equal and all are within one step (0.25 px)."""
    cfg = jcfg.FrontendConfig(**FE)
    got, ref = [], []
    for i in (0, 7):
        left, right = arc["left_f"][i], arc["right_f"][i]
        kp, _, _ = j_extract(jnp.asarray(left), cfg)
        disp0 = np.random.default_rng(i).uniform(1.0, 12.0, 256).astype(
            np.float32)
        ref.append(np.asarray(jst._refine_disparity(
            jnp.asarray(left), jnp.asarray(right), kp.xy, jnp.asarray(disp0),
            kp.level)))
        got.append(n(tst._refine_disparity(
            t(left), t(right), t(np.asarray(kp.xy)), t(disp0),
            t(np.asarray(kp.level)))))
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert (got == ref).mean() >= 0.99
    assert np.abs(got - ref).max() <= 0.25


@pytest.mark.parametrize("levels", [3, 5])
def test_extract_features_pair_equals_per_image(pairs, levels, monkeypatch):
    """Both pyramids of a pair go through K1 as one level list, one launch
    for every 8 levels of its level table (2 x 3 levels here: one launch;
    2 x 5: launches of 8 and 2): the features are those of
    `extract_features` on each image."""
    calls = []
    real = fused_fast.fast_nms_pyramid

    def spy(levels, thresholds, arc_length, border):
        calls.append(len(levels))
        return real(levels, thresholds, arc_length, border)

    cfg = tcfg.FrontendConfig(**dict(FE2, num_levels=levels))
    left, right = t(pairs["left"][3]), t(pairs["right"][3])
    monkeypatch.setattr(fused_fast, "fast_nms_pyramid", spy)
    pair = tst.extract_features_pair(left, right, cfg)
    monkeypatch.undo()
    assert calls == ([6] if levels == 3 else [8, 2])
    for img, (kp, ang, desc) in zip((left, right), pair):
        ref_kp, ref_ang, ref_desc = t_extract(img, cfg)
        for a, b in zip(kp, ref_kp):
            assert torch.equal(a, b)
        assert torch.equal(ang, ref_ang) and torch.equal(desc, ref_desc)
        assert int(kp.valid.sum()) > 100


def _jax_match(left, right, intr, cfg, dist_r=None, R_l=None, R_r=None):
    """best_j and matched as `jetracer_orbslam2_tpu/models/stereo.py` forms
    them inside `frontend_stereo` (it returns neither)."""
    kp_l, _, desc_l = j_extract(jnp.asarray(left), cfg)
    kp_r, _, desc_r = j_extract(jnp.asarray(right), cfg)
    xy_l, xy_r = kp_l.xy, kp_r.xy
    if cfg.dist is not None:
        xy_l = jgeo.undistort_pixels(xy_l, jnp.asarray(intr),
                                     jnp.asarray(cfg.dist), rect=R_l)
        xy_r = jgeo.undistort_pixels(xy_r, jnp.asarray(intr),
                                     jnp.asarray(dist_r), rect=R_r)
    d = jmatch.hamming_matrix(desc_l, desc_r, cfg.descriptor_bits)
    dv = jnp.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    gate = ((~kp_l.valid[:, None]) | (~kp_r.valid[None, :]) | (dv > 2.0)
            | (disp <= 0.1) | (disp > 128.0))
    d = jnp.where(gate, 1e9, d)
    best_j = np.asarray(jnp.argmin(d, axis=1))
    matched = np.asarray((jnp.min(d, axis=1) <= 48) & kp_l.valid)
    return best_j, matched


def _port_match(left, right, intr, cfg, dist_r=None, R_l=None, R_r=None):
    kp_l, _, desc_l = t_extract(t(left), cfg)
    kp_r, _, desc_r = t_extract(t(right), cfg)
    xy_l, xy_r = kp_l.xy, kp_r.xy
    if cfg.dist is not None:
        xy_l = tgeo.undistort_pixels(xy_l, t(intr), t(np.float32(cfg.dist)),
                                     rect=t(R_l))
        xy_r = tgeo.undistort_pixels(xy_r, t(intr), t(np.float32(dist_r)),
                                     rect=t(R_r))
    best_j, matched = tst._epipolar_match(
        xy_l, xy_r, kp_l.valid, kp_r.valid, desc_l, desc_r,
        cfg.descriptor_bits, 2.0, 128.0, 48)
    return n(best_j), n(matched)


def _assert_stereo_features_match(got, ref, xy_atol):
    """As the RGB-D front-end parity tests hold their features, plus the
    stereo depth: has_point on >= 99 % of keypoints, points to rtol 1e-5
    where both have one."""
    for name in ("level", "score", "valid"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    close(got["xy"], ref["xy"], rtol=0, atol=xy_atol)
    valid = ref["valid"]
    assert valid.sum() > 150
    d = np.abs(got["angle"] - ref["angle"])[valid]
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-4
    same = (got["desc"] == ref["desc"]).all(-1)
    bins_t = n(angle_bins(t(got["angle"]), 32))
    bins_j = n(angle_bins(t(ref["angle"]), 32))
    assert (same | (bins_t != bins_j))[valid].all()
    assert same[valid].mean() >= 0.99
    assert (got["has_point"] == ref["has_point"]).mean() >= 0.99
    both = got["has_point"] & ref["has_point"]
    assert both.sum() > 60
    close(got["points"][both], ref["points"][both], rtol=1e-5, atol=0)


def test_frontend_stereo_prerectified_matches(pairs):
    fj, ft = jcfg.FrontendConfig(**FE2), tcfg.FrontendConfig(**FE2)
    intr = pairs["intr"]
    for i in (0, 6):
        left, right = pairs["left"][i], pairs["right"][i]
        ref = jax_features_to_numpy(jst.frontend_stereo(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(intr), 0.11, fj))
        got = features_to_numpy(tst.frontend_stereo(
            t(left), t(right), t(intr), 0.11, ft, device="cpu"))
        _assert_stereo_features_match(got, ref, xy_atol=0)
        bj, mj = _jax_match(left, right, intr, fj)
        bt, mt = _port_match(left, right, intr, ft)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(bt, bj)


def test_frontend_stereo_distorted_rig_matches(distorted):
    s = distorted
    R_l, R_r, b = jds.stereo_rectify_rotations(s["T_c1_c0"][:3, :3],
                                               s["T_c1_c0"][:3, 3])
    Rt_l, Rt_r, bt = tds.stereo_rectify_rotations(s["T_c1_c0"][:3, :3],
                                                  s["T_c1_c0"][:3, 3])
    np.testing.assert_array_equal(Rt_l, R_l)
    np.testing.assert_array_equal(Rt_r, R_r)
    assert bt == b
    rect = dict(dist_r=DIST_R, rect_l=tuple(float(x) for x in R_l.ravel()),
                rect_r=tuple(float(x) for x in R_r.ravel()))
    fj = jcfg.FrontendConfig(**FE2, dist=DIST)
    ft = tcfg.FrontendConfig(**FE2, dist=DIST)
    ref = jax_features_to_numpy(jst.frontend_stereo(
        jnp.asarray(s["left"]), jnp.asarray(s["right"]), jnp.asarray(s["intr"]),
        b, fj, **rect))
    got = features_to_numpy(tst.frontend_stereo(
        t(s["left"]), t(s["right"]), t(s["intr"]), b, ft, **rect, device="cpu"))
    # undistortion is 8 fixed-point steps of f32 arithmetic on each side
    _assert_stereo_features_match(got, ref, xy_atol=1e-3)
    bj, mj = _jax_match(s["left"], s["right"], s["intr"], fj, DIST_R,
                        jnp.asarray(R_l), jnp.asarray(R_r))
    bt, mt = _port_match(s["left"], s["right"], s["intr"], ft, DIST_R, R_l, R_r)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(bt, bj)


def test_stereo_frontend_depth_matches_gt():
    """Stereo-matched keypoint depth agrees with the renderer's (the JAX
    package's test of the same name, on the port's own generator)."""
    h, w = 240, 320
    seq = tsyn.generate_stereo_sequence(n_frames=1, shape=(h, w), baseline=0.2,
                                        device="cpu")
    cfg = tcfg.FrontendConfig(height=h, width=w, num_levels=3,
                              max_keypoints=512)
    f = tst.frontend_stereo(seq.left[0], seq.right[0], seq.intrinsics,
                            seq.baseline, cfg, max_depth=20.0, device="cpu")
    assert int(f.has_point.sum()) > 100
    xy = n(f.xy).astype(int)
    gt_z = n(seq.depth[0])[np.clip(xy[:, 1], 0, h - 1), np.clip(xy[:, 0], 0, w - 1)]
    mask = n(f.has_point)
    rel_err = np.abs(n(f.points)[:, 2][mask] - gt_z[mask]) / gt_z[mask]
    assert np.median(rel_err) < 0.05, np.median(rel_err)
    assert (rel_err < 0.15).mean() > 0.85


def test_stereo_frontend_keypoint_rectification():
    """Distorted rig with a tilted right camera: keypoint-level rectification
    recovers metric depth, and treating the rig as pre-rectified is badly
    biased (the JAX package's test of the same name, with its bars)."""
    h, w = 240, 320
    seq = tsyn.generate_stereo_sequence(
        n_frames=1, shape=(h, w), dist_l=DIST, dist_r=DIST_R,
        right_rotation=ROT, device="cpu")
    shift = np.eye(4)
    shift[0, 3] = seq.baseline
    shift[:3, :3] = n(tgeo.so3_exp(torch.tensor(ROT))).astype(np.float64)
    T_c1_c0 = np.linalg.inv(shift)
    R_l, R_r, b = tds.stereo_rectify_rotations(T_c1_c0[:3, :3], T_c1_c0[:3, 3])
    cfg = tcfg.FrontendConfig(height=h, width=w, num_levels=3,
                              max_keypoints=256, dist=DIST)
    feats = tst.frontend_stereo(
        seq.left[0], seq.right[0], seq.intrinsics, b, cfg, dist_r=DIST_R,
        rect_l=tuple(float(x) for x in R_l.ravel()),
        rect_r=tuple(float(x) for x in R_r.ravel()), device="cpu")
    has = n(feats.has_point)
    assert has.sum() >= 60, has.sum()
    dist = torch.tensor(DIST)
    xy_raw = n(tgeo.distort_pixels(feats.xy, seq.intrinsics, dist,
                                   rect=t(R_l)))[has]
    xi = np.clip(np.round(xy_raw[:, 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(xy_raw[:, 1]).astype(int), 0, h - 1)
    z_gt = n(seq.depth[0])[yi, xi]
    pts_gt = n(tgeo.deproject(t(xy_raw), t(z_gt), seq.intrinsics, dist))
    err = np.linalg.norm(n(feats.points)[has] - pts_gt @ R_l.T, axis=-1)
    rel = err / np.maximum(z_gt, 0.1)
    assert np.median(rel) < 0.03, np.median(rel)

    naive = tst.frontend_stereo(
        seq.left[0], seq.right[0], seq.intrinsics, b,
        tcfg.FrontendConfig(height=h, width=w, num_levels=3, max_keypoints=256),
        device="cpu")
    has_n = n(naive.has_point)
    xy_n = n(naive.xy)[has_n]
    z_gt_n = n(seq.depth[0])[np.clip(np.round(xy_n[:, 1]).astype(int), 0, h - 1),
                             np.clip(np.round(xy_n[:, 0]).astype(int), 0, w - 1)]
    rel_n = np.abs(n(naive.points)[has_n][:, 2] - z_gt_n) / np.maximum(z_gt_n, 0.1)
    assert np.median(rel_n) > 2.0 * np.median(rel), (np.median(rel_n),
                                                      np.median(rel))


MAP = dict(max_keyframes=16, max_landmarks=2048, max_obs=8192, kf_min_gap=2,
           kf_max_gap=4, window_size=4)


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb.astype(np.float64)) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_stereo_slam_scan_matches_jax_and_the_host_loop(arc):
    """The slice as a whole: the stereo slam_scan over a 12-frame arc against
    the JAX package's on the same frames (tracked flags equal, poses within
    5 mm and 0.1 deg, as the odometry scan is held), and against the port's
    host `Slam` fed `frontend_stereo` (poses 1e-3)."""
    left, right, intr = arc["left"], arc["right"], arc["intr"]
    track = dict(max_depth=80.0)
    jc = jcfg.SystemConfig(
        frontend=jcfg.FrontendConfig(**FE), map=jcfg.MapConfig(**MAP),
        tracking=jcfg.TrackingConfig(**track),
        stereo=jcfg.StereoConfig(baseline=0.11))
    tc = tcfg.SystemConfig(
        frontend=tcfg.FrontendConfig(**FE), map=tcfg.MapConfig(**MAP),
        tracking=tcfg.TrackingConfig(**track),
        stereo=tcfg.StereoConfig(baseline=0.11))
    st = jss.init_scan_state(jnp.asarray(left[0]), jnp.asarray(right[0]),
                             jnp.asarray(intr), jc)
    fj, oj = jss.slam_scan(st, jnp.asarray(left[1:]), jnp.asarray(right[1:]),
                           jnp.asarray(intr), jc)
    pj = np.concatenate([np.asarray(fj.m.kf_pose[:1]),
                         np.asarray(jss.compose_trajectory(fj, oj))])
    st = tss.init_scan_state(left[0], right[0], intr, tc, device="cpu")
    ft, ot = tss.slam_scan(st, left[1:], right[1:], intr, tc)
    pt = np.concatenate([n(ft.m.kf_pose[:1]), tss.compose_trajectory(ft, ot)])
    np.testing.assert_array_equal(n(ot.tracked), np.asarray(oj.tracked))
    assert n(ot.tracked).all()
    assert int(ft.m.num_kf) == int(fj.m.num_kf) >= 2
    for a, b in zip(pt, pj):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 5e-3
        assert _rot_deg(a[:3, :3], b[:3, :3]) < 0.1

    slam = tslam.Slam(tc, intr, device="cpu")
    for i in range(left.shape[0]):
        slam.process_features(tst.frontend_stereo(
            left[i], right[i], intr, 0.11, tc.frontend,
            min_depth=tc.tracking.min_depth, max_depth=80.0, device="cpu"))
    o = slam.result()
    np.testing.assert_array_equal(o.tracked[1:], n(ot.tracked))
    assert o.num_keyframes == int(ft.m.num_kf)
    close(o.poses, pt, rtol=0, atol=1e-3)
