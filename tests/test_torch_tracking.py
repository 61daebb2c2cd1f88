"""Tracking of the PyTorch port vs the JAX package (CPU).

The RANSAC stream of `jax.random` cannot be reproduced by a torch generator,
so the sample indices JAX draws are recomputed here from the same key and
logits and injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
from jetracer_orbslam2_tpu.config import TrackingConfig as JTrackingConfig
from jetracer_orbslam2_tpu.io.synthetic import generate_sequence as j_generate_sequence
from jetracer_orbslam2_tpu.models import tracking as jtrack
from jetracer_orbslam2_tpu.models.frontend import frontend_gray_depth as j_frontend
from jetracer_orbslam2_tpu.ops import geometry as jgeo
from jetracer_orbslam2_tpu.ops import match as jmatch

from jetracer_orbslam2_torch.config import TrackingConfig
from jetracer_orbslam2_torch.convert import features_from_numpy
from jetracer_orbslam2_torch.models import tracking as ttrack

from _torch_port_util import jax_features_to_numpy, n, t

close = np.testing.assert_allclose


def _correspondences(seed, k=200, outliers=0.3, noise=0.005):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.03, 3)]).astype(np.float32)
    T = n(jgeo.se3_exp(jnp.asarray(xi)))
    src = (rng.uniform(-1, 1, (k, 3)) * [2.0, 1.5, 0] + [0, 0, 0]).astype(np.float32)
    src[:, 2] = rng.uniform(0.8, 5.0, k)
    dst = src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, noise, (k, 3))
    bad = rng.random(k) < outliers
    dst[bad] += rng.normal(0, 0.5, (int(bad.sum()), 3))
    w = (rng.random(k) > 0.25).astype(np.float32)
    return src, dst.astype(np.float32), w, T


def _jax_samples(key, weights, iters):
    """The draw `jetracer_orbslam2_tpu.models.tracking.ransac_kabsch` makes."""
    logits = jnp.log(jnp.maximum(jnp.asarray(weights), 1e-20))
    return np.asarray(jax.random.categorical(key, logits, shape=(iters, 3)))


@pytest.mark.parametrize("seed,depth_quad", [(0, 0.0), (1, 0.02), (2, 0.02)])
def test_ransac_kabsch_with_injected_samples(seed, depth_quad):
    src, dst, w, T_true = _correspondences(seed)
    key = jax.random.PRNGKey(seed)
    ref = jtrack.ransac_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                               key, iters=64, depth_quad=depth_quad)
    idx = _jax_samples(key, w, 64)
    got = ttrack.ransac_kabsch(t(src), t(dst), t(w), None, iters=64,
                               depth_quad=depth_quad, sample_idx=t(idx))
    np.testing.assert_array_equal(n(got.inliers), n(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 50
    assert bool(got.ok) and bool(ref.ok)
    # two weighted SVD Kabsch solves over ~100 inliers: atol 1e-5
    close(n(got.T), n(ref.T), rtol=0, atol=1e-5)
    close(n(got.T), T_true, rtol=0, atol=2e-2)
    assert got.num_inliers.dtype == torch.int32


def test_ransac_kabsch_zero_weights_does_not_raise():
    src, dst, w, _ = _correspondences(3, k=64)
    g = torch.Generator().manual_seed(0)
    got = ttrack.ransac_kabsch(t(src), t(dst), torch.zeros(64), g, iters=32)
    assert not bool(got.ok)
    assert int(got.num_inliers) == 0
    np.testing.assert_array_equal(n(got.T), np.eye(4, dtype=np.float32))
    ref = jtrack.ransac_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.zeros(64),
                               jax.random.PRNGKey(0), iters=32)
    assert not bool(ref.ok)
    np.testing.assert_array_equal(n(got.inliers), n(ref.inliers))


def test_ransac_kabsch_own_draws_find_the_motion():
    src, dst, w, T_true = _correspondences(4)
    g = torch.Generator().manual_seed(7)
    a = ttrack.ransac_kabsch(t(src), t(dst), t(w), g, iters=128)
    assert bool(a.ok)
    close(n(a.T), T_true, rtol=0, atol=2e-2)
    # same seed, same draws; the generator advances between calls
    b = ttrack.ransac_kabsch(t(src), t(dst), t(w),
                             torch.Generator().manual_seed(7), iters=128)
    np.testing.assert_array_equal(n(a.T), n(b.T))


def test_refine_pose_reprojection_matches():
    rng = np.random.default_rng(5)
    k = 150
    intr = np.float32([144.0, 144.0, 79.5, 59.5])
    xi = np.concatenate([rng.normal(0, 0.04, 3), rng.normal(0, 0.02, 3)]).astype(np.float32)
    T = n(jgeo.se3_exp(jnp.asarray(xi)))
    X = np.stack([rng.uniform(-1.5, 1.5, k), rng.uniform(-1, 1, k),
                  rng.uniform(1, 5, k)], -1).astype(np.float32)
    P = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([intr[0] * P[:, 0] / P[:, 2] + intr[2],
                   intr[1] * P[:, 1] / P[:, 2] + intr[3]], -1)
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    uv[:10] += 25.0                                        # Huber-weighted outliers
    z = (P[:, 2] + rng.normal(0, 0.01, k)).astype(np.float32)
    z[::7] = 0.0                                           # no depth anchor there
    w = (rng.random(k) > 0.2).astype(np.float32)
    T0 = np.eye(4, dtype=np.float32)
    ref = jtrack.refine_pose_reprojection(
        jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(z),
        jnp.asarray(w), jnp.asarray(intr))
    got = ttrack.refine_pose_reprojection(t(T0), t(X), t(uv), t(z), t(w), t(intr))
    # five Gauss-Newton steps, each a 6x6 solve of ~150 summed blocks: 1e-5
    close(n(got), n(ref), rtol=0, atol=1e-5)
    close(n(got), T, rtol=0, atol=5e-3)


@pytest.fixture(scope="module")
def two_frames():
    seq = j_generate_sequence(n_frames=2, shape=(120, 160), step=0.03)
    gray = np.round(np.asarray(seq.gray))              # 8-bit camera
    depth = np.asarray(seq.depth)
    fcfg = JFrontendConfig(height=120, width=160, num_levels=2, max_keypoints=256)
    feats = [j_frontend(jnp.asarray(gray[i]), jnp.asarray(depth[i]),
                        seq.intrinsics, fcfg) for i in range(2)]
    return feats, np.asarray(seq.intrinsics)


def test_track_rgbd_with_injected_samples(two_frames):
    (prev_j, curr_j), intr = two_frames
    tcfg_j = JTrackingConfig(ransac_iters=64)
    tcfg_t = TrackingConfig(ransac_iters=64)
    assert tcfg_j == JTrackingConfig(**tcfg_t.__dict__)
    eye = np.eye(4, dtype=np.float32)
    key = jax.random.PRNGKey(11)
    ref = jtrack.track_rgbd(prev_j, curr_j, jnp.asarray(eye), jnp.asarray(eye),
                            jnp.asarray(intr), key, tcfg_j)

    # the weights JAX's RANSAC samples from: validity of the matched pairs
    xy_pred = jgeo.project(prev_j.points, jnp.asarray(intr))
    m = jmatch.match(prev_j.desc, curr_j.desc, prev_j.has_point, curr_j.has_point,
                     xy_a_pred=xy_pred, xy_b=curr_j.xy, window=tcfg_j.match_window,
                     max_hamming=tcfg_j.match_max_hamming, ratio=tcfg_j.match_ratio)
    pair_ok = np.asarray(m.valid & jnp.take(curr_j.has_point, m.idx))
    idx = _jax_samples(key, pair_ok.astype(np.float32), 64)

    prev_t = features_from_numpy(jax_features_to_numpy(prev_j), "cpu")
    curr_t = features_from_numpy(jax_features_to_numpy(curr_j), "cpu")
    got = ttrack.track_rgbd(prev_t, curr_t, t(eye), t(eye), t(intr), None,
                            tcfg_t, sample_idx=t(idx))
    np.testing.assert_array_equal(n(got.match_idx), n(ref.match_idx))
    np.testing.assert_array_equal(n(got.inlier_mask), n(ref.inlier_mask))
    assert bool(got.tracked_ok) and bool(ref.tracked_ok)
    assert int(got.num_matches) == int(ref.num_matches) > 30
    assert int(got.num_inliers) == int(ref.num_inliers)
    # RANSAC consensus + Gauss-Newton polish on identical inliers: 1e-4
    close(n(got.T_wc), n(ref.T_wc), rtol=0, atol=1e-4)
    close(n(got.velocity), n(ref.velocity), rtol=0, atol=1e-4)


def test_track_rgbd_falls_back_to_motion_model(two_frames):
    (prev_j, curr_j), intr = two_frames
    prev_t = features_from_numpy(jax_features_to_numpy(prev_j), "cpu")
    curr_np = jax_features_to_numpy(curr_j)
    curr_np["has_point"] = np.zeros_like(curr_np["has_point"])    # nothing to match
    curr_t = features_from_numpy(curr_np, "cpu")
    vel = n(jgeo.se3_exp(jnp.asarray([0.0, 0.0, 0.03, 0.0, 0.004, 0.0], jnp.float32)))
    T_prev = n(jgeo.se3_exp(jnp.asarray([0.1, 0.0, 0.5, 0.0, 0.1, 0.0], jnp.float32)))
    got = ttrack.track_rgbd(prev_t, curr_t, t(T_prev), t(vel), t(intr),
                            torch.Generator().manual_seed(0), TrackingConfig())
    assert not bool(got.tracked_ok)
    assert int(got.num_matches) == 0
    close(n(got.T_wc), T_prev @ vel, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(got.velocity), vel)


def _icp_clouds(seed):
    """64 points seen before and after a known small motion, with masks."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.02, 3)]).astype(np.float32)
    T = n(jgeo.se3_exp(jnp.asarray(xi)))
    src = rng.uniform(-1.0, 1.0, (64, 3)).astype(np.float32) * [1.5, 1.0, 0.5]
    src = (src + [0.0, 0.0, 3.0]).astype(np.float32)
    dst = (src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.002, (64, 3))).astype(np.float32)
    src_mask = rng.random(64) > 0.15
    dst_mask = rng.random(64) > 0.1
    return src, dst, src_mask, dst_mask, T


@pytest.mark.parametrize("masked,with_init,iters", [
    (False, False, 10), (True, False, 8), (True, True, 6)])
def test_icp_matches_jax(masked, with_init, iters):
    """ICP against the JAX package on 64 points, compared as transforms (SVD
    factors are not defined across libraries), atol 1e-4."""
    src, dst, sm, dm, T_true = _icp_clouds(3 + iters)
    if not masked:
        sm = dm = np.ones(64, bool)
    T0 = None
    if with_init:
        T0 = n(jgeo.se3_exp(jnp.asarray([0.01, -0.01, 0.0, 0.02, 0.0, -0.01],
                                        jnp.float32)))
    ref_T, ref_err = jtrack.icp(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(sm), jnp.asarray(dm),
        iters=iters, T_init=None if T0 is None else jnp.asarray(T0))
    got_T, got_err = ttrack.icp(
        t(src), t(dst), t(sm), t(dm), iters=iters,
        T_init=None if T0 is None else t(T0))
    close(n(got_T), n(ref_T), rtol=0, atol=1e-4)
    close(float(got_err), float(ref_err), rtol=0, atol=1e-5)
    if not masked:
        # every point has its partner: both find the motion (a masked-out
        # partner leaves a point a wrong neighbour, and a biased fit)
        close(n(got_T), T_true, rtol=0, atol=1e-2)
    assert got_T.dtype == torch.float32 and got_T.shape == (4, 4)
