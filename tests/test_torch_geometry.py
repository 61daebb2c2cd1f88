"""Geometry and depth ops of the PyTorch port vs the JAX package (CPU).

Tolerances: these are chains of f32 transcendental and small matrix ops whose
last bits differ between XLA and torch; each bound is stated at the test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.ops import align as jalign
from jetracer_orbslam2_tpu.ops import geometry as jgeo

from jetracer_orbslam2_torch.ops import align as talign
from jetracer_orbslam2_torch.ops import geometry as tgeo

from _torch_port_util import n, t

close = np.testing.assert_allclose


def _twists(seed=0, count=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1.0, (count, 3)).astype(np.float32)
    w[:4] *= 1e-6                       # small-angle (Taylor) branch
    w[4] = 0.0
    axis = rng.normal(0, 1, (4, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w[5:9] = (axis * 3.1).astype(np.float32)   # near-pi branch of the log
    v = rng.normal(0, 2.0, (count, 3)).astype(np.float32)
    return np.concatenate([v, w], -1)


def test_hat_and_so3_exp_match():
    xi = _twists()
    w = xi[:, 3:]
    np.testing.assert_array_equal(n(tgeo.hat(t(w))), n(jgeo.hat(jnp.asarray(w))))
    # sin/cos/sqrt of f32 differ by an ulp between the libraries: atol 1e-6
    close(n(tgeo.so3_exp(t(w))), n(jgeo.so3_exp(jnp.asarray(w))), rtol=0, atol=1e-6)


def test_so3_round_trip_and_log_match():
    w = _twists()[:, 3:]
    R = n(jgeo.so3_exp(jnp.asarray(w)))
    got = n(tgeo.so3_log(t(R)))
    # arccos near +-1 amplifies an ulp of the trace: atol 2e-5 on the near-pi
    # rows, 1e-6 elsewhere
    ref = n(jgeo.so3_log(jnp.asarray(R)))
    close(got[9:], ref[9:], rtol=0, atol=1e-6)
    close(got[:9], ref[:9], rtol=0, atol=2e-5)
    # round trip in the port alone, away from the near-pi rows (there the
    # axis is recovered from sqrt of the diagonal and loses half the digits,
    # on both sides alike)
    back = n(tgeo.so3_exp(tgeo.so3_log(t(R[9:]))))
    close(back, R[9:], rtol=0, atol=2e-6)


def test_se3_exp_log_match_and_round_trip():
    xi = _twists(1)
    T_t = tgeo.se3_exp(t(xi))
    T_j = jgeo.se3_exp(jnp.asarray(xi))
    # translation magnitudes ~5: atol 1e-6 relative to that scale
    close(n(T_t), n(T_j), rtol=0, atol=5e-6)
    rows = slice(9, None)                 # away from theta ~ pi
    xi_t = n(tgeo.se3_log(T_t))
    xi_j = n(jgeo.se3_log(T_j))
    close(xi_t[rows], xi_j[rows], rtol=0, atol=5e-6)
    # log(exp(xi)) == xi only while the angle stays below pi
    below_pi = np.linalg.norm(xi[:, 3:], axis=1) < 3.0
    below_pi[:9] = False
    assert below_pi.sum() > 40
    close(xi_t[below_pi], xi[below_pi], rtol=0, atol=2e-5)


def test_pose_helpers_match():
    xi = _twists(2, 16)
    T = n(jgeo.se3_exp(jnp.asarray(xi)))
    pts = np.random.default_rng(3).normal(0, 2, (16, 50, 3)).astype(np.float32)
    close(n(tgeo.pose_inverse(t(T))), n(jgeo.pose_inverse(jnp.asarray(T))),
          rtol=0, atol=2e-6)
    close(n(tgeo.transform_points(t(T), t(pts))),
          n(jgeo.transform_points(jnp.asarray(T), jnp.asarray(pts))),
          rtol=0, atol=5e-6)
    R, tr = T[:, :3, :3], T[:, :3, 3]
    np.testing.assert_array_equal(n(tgeo.pose_from_rt(t(R), t(tr))), T)


_DIST = {
    "none": (None, "brown_conrady"),
    "brown_conrady": ((-0.28, 0.07, 2e-4, -1e-4, 0.01), "brown_conrady"),
    "ftheta": ((0.9,), "ftheta"),
}


@pytest.mark.parametrize("kind", list(_DIST))
def test_project_deproject_undistort_match(kind):
    dist, model = _DIST[kind]
    rng = np.random.default_rng(4)
    intr = np.float32([144.0, 144.0, 79.5, 59.5])
    pix = rng.uniform(0, 1, (200, 2)).astype(np.float32) * np.float32([160, 120])
    z = rng.uniform(0.3, 6.0, 200).astype(np.float32)
    dj = None if dist is None else jnp.asarray(dist, jnp.float32)
    dt = None if dist is None else torch.tensor(dist, dtype=torch.float32)
    P_j = jgeo.deproject(jnp.asarray(pix), jnp.asarray(z), jnp.asarray(intr), dj, model)
    P_t = tgeo.deproject(t(pix), t(z), t(intr), dt, model)
    close(n(P_t), n(P_j), rtol=0, atol=1e-5)                     # metres
    # pixels: atol 1e-4 px
    close(n(tgeo.project(t(n(P_j)), t(intr), dt, model)),
          n(jgeo.project(P_j, jnp.asarray(intr), dj, model)), rtol=0, atol=1e-4)
    close(n(tgeo.undistort_pixels(t(pix), t(intr), dt, model)),
          n(jgeo.undistort_pixels(jnp.asarray(pix), jnp.asarray(intr), dj, model)),
          rtol=0, atol=1e-4)
    if dist is not None:
        rect = n(jgeo.so3_exp(jnp.asarray([0.01, -0.02, 0.005], jnp.float32)))
        close(n(tgeo.undistort_pixels(t(pix), t(intr), dt, model, rect=t(rect))),
              n(jgeo.undistort_pixels(jnp.asarray(pix), jnp.asarray(intr), dj,
                                      model, rect=jnp.asarray(rect))),
              rtol=0, atol=1e-4)


def _rigid_problem(rng, count, noise=0.0):
    xi = np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 0.4, 3)]).astype(np.float32)
    T = n(jgeo.se3_exp(jnp.asarray(xi)))
    src = rng.normal(0, 1.5, (count, 3)).astype(np.float32)
    dst = src @ T[:3, :3].T + T[:3, 3]
    dst = (dst + rng.normal(0, noise, dst.shape)).astype(np.float32)
    return src, dst, T


@pytest.mark.parametrize("solver", ["kabsch", "kabsch_quat"])
@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_matches(solver, weighted):
    rng = np.random.default_rng(5)
    src, dst, T = _rigid_problem(rng, 120, noise=0.01)
    w = (rng.random(120) > 0.3).astype(np.float32) if weighted else None
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else t(w)
    got = n(getattr(tgeo, solver)(t(src), t(dst), wt))
    ref = n(getattr(jgeo, solver)(jnp.asarray(src), jnp.asarray(dst), wj))
    # transforms (never SVD factors) compared: atol 1e-5
    close(got, ref, rtol=0, atol=1e-5)
    close(got, T, rtol=0, atol=2e-2)


@pytest.mark.parametrize("solver", ["kabsch", "kabsch_quat"])
def test_kabsch_minimal_three_point_batches(solver):
    rng = np.random.default_rng(6)
    src, dst, T = _rigid_problem(rng, 64 * 3)
    src, dst = src.reshape(64, 3, 3), dst.reshape(64, 3, 3)
    got = n(getattr(tgeo, solver)(t(src), t(dst)))
    ref = n(getattr(jgeo, solver)(jnp.asarray(src), jnp.asarray(dst)))
    # A minimal set is as well conditioned as its triangle is fat.  Measured
    # on this batch against the exact transform, in f32: the SVD solver is
    # within 3.5e-5 (XLA) / 1.5e-5 (torch); the quaternion solver, whose
    # quartic has a near-double root on thin triangles, within 1.6e-4 (XLA) /
    # 1.1e-3 (torch) on its worst sample and within 5e-5 on all but two.  So
    # the bulk is held to 1e-5-grade agreement and every sample to the
    # solver's own accuracy; in f64 the port's quaternion solver is within
    # 6e-7 of the truth on every sample (checked below), i.e. the formula is
    # the same and only f32 conditioning separates the two.
    err = np.abs(got - ref).max(axis=(1, 2))
    assert np.median(err) < 1e-5
    assert np.quantile(err, 0.9) < 5e-5
    worst = 1e-4 if solver == "kabsch" else 5e-3
    assert err.max() < worst
    assert np.abs(got - T).max() < worst
    got64 = n(getattr(tgeo, solver)(t(src).double(), t(dst).double()))
    close(got64, np.broadcast_to(T, got.shape), rtol=0, atol=5e-6)


def test_kabsch_quat_degenerate_samples_agree():
    # RANSAC draws with replacement: repeated points give a rank-deficient
    # correlation; the adjugate-column argmax must break ties alike
    rng = np.random.default_rng(7)
    src, dst, _ = _rigid_problem(rng, 8 * 3)
    src, dst = src.reshape(8, 3, 3).copy(), dst.reshape(8, 3, 3).copy()
    src[0, 1:] = src[0, 0]; dst[0, 1:] = dst[0, 0]        # one point, thrice
    src[1, 2] = src[1, 1]; dst[1, 2] = dst[1, 1]          # two distinct points
    got = n(tgeo.kabsch_quat(t(src), t(dst)))
    ref = n(jgeo.kabsch_quat(jnp.asarray(src), jnp.asarray(dst)))
    assert np.isfinite(got).all()
    # row 0 is a pure translation on both sides; row 1's rotation about the
    # two-point axis is undetermined, so only its fit of the points is held
    close(got[0], ref[0], rtol=0, atol=1e-5)
    # (a rank-1 correlation makes the top eigenvalue double; measured fit
    # error in f32: 2.3e-4 m in the port, 6.7e-2 m in the JAX package, so the
    # two are not compared with each other here)
    fit = src[1] @ got[1, :3, :3].T + got[1, :3, 3]
    close(fit, dst[1], rtol=0, atol=1e-3)


def test_sample_depth_and_backproject_exact():
    rng = np.random.default_rng(8)
    depth = rng.uniform(0.2, 9.0, (60, 80)).astype(np.float32)
    depth[rng.random((60, 80)) < 0.3] = 0.0               # speckle holes
    depth[20:30, 30:45] = 0.0                             # a hole wider than 3x3
    xy = rng.uniform(-2, 1, (300, 2)).astype(np.float32) * np.float32([-80, -60])
    xy[:20] = np.round(xy[:20]) + 0.5                     # half-to-even rounding
    intr = np.float32([72.0, 72.0, 39.5, 29.5])
    np.testing.assert_array_equal(
        n(talign.sample_depth(t(depth), t(xy))),
        n(jalign.sample_depth(jnp.asarray(depth), jnp.asarray(xy))))
    pts_t, ok_t = talign.backproject_keypoints(t(xy), t(depth), t(intr))
    pts_j, ok_j = jalign.backproject_keypoints(
        jnp.asarray(xy), jnp.asarray(depth), jnp.asarray(intr))
    np.testing.assert_array_equal(n(ok_t), n(ok_j))
    # (x - cx) / fx * z: one division and one product per coordinate, which
    # XLA may rewrite as a reciprocal multiply: 1 ulp of a value <= 9 m
    close(n(pts_t), n(pts_j), rtol=0, atol=1e-6)
    assert 0 < int(n(ok_j).sum()) < 300
