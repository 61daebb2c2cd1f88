"""Loop closure of the PyTorch port vs the JAX package (CPU): retrieval,
geometric verification with the JAX package's own RANSAC samples injected,
the gated decision over a sequence of keyframes, and the pose-graph
correction on a map the JAX package built."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import LoopClosureConfig as JLoopConfig
from jetracer_orbslam2_tpu.config import PoseGraphConfig as JPoseGraphConfig
from jetracer_orbslam2_tpu.models.backend import loop as jloop
from jetracer_orbslam2_tpu.ops import match as jmatch

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import LoopClosureConfig, PoseGraphConfig
from jetracer_orbslam2_torch.models.backend import loop as tloop

from _torch_port_util import (
    INTR, assert_maps_equal, build_maps, jax_map_to_numpy, n, t)

close = np.testing.assert_allclose

LOOP = dict(min_sim=0.2, min_kf_gap=3, min_inliers=12, world_min_inliers=6)
N_KF = 12


@pytest.fixture(scope="module")
def maps():
    """Twelve keyframes of one synthetic world in both packages' maps."""
    return build_maps(dict(max_keyframes=16, max_landmarks=512, max_obs=4096),
                      N_KF, check=False)


def _jax_samples(key, weights, iters=tloop.VERIFY_RANSAC_ITERS):
    logits = jnp.log(jnp.maximum(jnp.asarray(weights, jnp.float32), 1e-20))
    return np.asarray(jax.random.categorical(key, logits, shape=(iters, 3)))


def _pair_weights(jm, a, b):
    """The weights `_verify_pair` samples from for keyframes a (query), b."""
    res = jmatch.match(jm.kf_desc[a], jm.kf_desc[b], jm.kf_has_point[a],
                       jm.kf_has_point[b], xy_a_pred=None, xy_b=None,
                       window=0.0, max_hamming=80.0, mutual=True)
    return np.asarray(res.valid & jm.kf_has_point[b][res.idx])


def test_centered_sims_matches():
    rng = np.random.default_rng(0)
    table = rng.random((16, 256), np.float32)
    q = rng.random(256, np.float32)
    table[3] = 0.5                        # a zero-norm row
    # a 256-term dot product and two norms in f32: 1e-6
    close(n(tloop._centered_sims(t(table), t(q))),
          n(jloop._centered_sims(jnp.asarray(table), jnp.asarray(q))),
          rtol=0, atol=1e-6)


@pytest.mark.parametrize("slot", [2, 7, 11])
def test_retrieve_matches(maps, slot):
    tm, jm = maps
    want = jloop.retrieve(jm, jnp.int32(slot), 0.2, min_kf_gap=3)
    got = tloop.retrieve(tm, slot, 0.2, min_kf_gap=3, device="cpu")
    assert int(got.kf_idx) == int(want.kf_idx)
    assert bool(got.ok) == bool(want.ok) == (slot > 3)
    close(n(got.score), n(want.score), rtol=0, atol=1e-6)
    assert got.kf_idx.dtype == torch.int32


@pytest.mark.parametrize("slot", [2, 5, 11])
def test_retrieve_topn_matches(maps, slot):
    tm, jm = maps
    want = jloop.retrieve_topn(jm, jnp.int32(slot), 0.2, min_kf_gap=3, topn=3)
    got = tloop.retrieve_topn(tm, torch.tensor(slot), 0.2, min_kf_gap=3,
                              topn=3, device="cpu")
    # slot 2 has no eligible keyframe: three scores of -1, a tie that both
    # resolve in slot order
    np.testing.assert_array_equal(n(got.kf_idx), n(want.kf_idx))
    np.testing.assert_array_equal(n(got.ok), n(want.ok))
    close(n(got.score), n(want.score), rtol=0, atol=1e-6)


def test_retrieve_global_matches(maps):
    tm, jm = maps
    gdesc = np.asarray(jm.kf_global_desc[4]) + np.float32(0.01)
    want = jloop.retrieve_global(jm, jnp.asarray(gdesc), jnp.float32(0.4))
    got = tloop.retrieve_global(tm, t(gdesc), 0.4, device="cpu")
    assert int(got.kf_idx) == int(want.kf_idx) == 4
    assert bool(got.ok) and bool(want.ok)
    empty = tloop.retrieve_global(
        tm._replace(kf_valid=torch.zeros_like(tm.kf_valid)), t(gdesc), 0.4,
        device="cpu")
    assert not bool(empty.ok) and int(empty.kf_idx) == 0


@pytest.mark.parametrize("a,b", [(11, 2), (8, 0)])
def test_verify_with_injected_samples(maps, a, b):
    tm, jm = maps
    jcfg, tcfg = JLoopConfig(**LOOP), LoopClosureConfig(**LOOP)
    key = jax.random.PRNGKey(a)
    want = jloop.verify(jm, jnp.int32(a), jnp.int32(b), key, jcfg)
    idx = _jax_samples(key, _pair_weights(jm, a, b))
    got = tloop.verify(tm, a, b, None, tcfg, sample_idx=t(idx), device="cpu")
    assert int(got.num_inliers) == int(want.num_inliers) > 40
    assert bool(got.ok) and bool(want.ok)
    # consensus of 512 hypotheses, two SVD Kabsch refits on equal inliers
    close(n(got.T_ab), n(want.T_ab), rtol=0, atol=1e-4)
    # T_ab maps b's camera frame into a's
    truth = np.linalg.inv(n(jm.kf_pose[a])) @ n(jm.kf_pose[b])
    close(n(got.T_ab), truth, rtol=0, atol=3e-2)
    # the relocalization entry with the same features is the same solve
    feats = (tm.kf_desc[a], tm.kf_has_point[a], tm.kf_points[a])
    again = tloop.verify_features(
        tm, *feats, b, None, tcfg.ransac_inlier_thresh, tcfg.min_inliers,
        tcfg.ransac_depth_quad, sample_idx=t(idx), device="cpu")
    assert torch.equal(again.T_ab, got.T_ab)


def test_verify_draws_from_the_generator(maps):
    tm, _ = maps
    cfg = LoopClosureConfig(**LOOP)
    g = torch.Generator().manual_seed(3)
    first = tloop.verify(tm, 11, 2, g, cfg, device="cpu")
    second = tloop.verify(tm, 11, 2, g, cfg, device="cpu")   # advanced
    same = tloop.verify(tm, 11, 2, torch.Generator().manual_seed(3), cfg,
                        device="cpu")
    assert bool(first.ok) and bool(second.ok)
    assert torch.equal(first.T_ab, same.T_ab)
    close(n(first.T_ab), n(second.T_ab), rtol=0, atol=2e-2)


@pytest.mark.parametrize("window,max_obs", [(16.0, 256), (16.0, 40)])
def test_verify_world_matches(maps, window, max_obs):
    """The candidate's landmarks at their current positions reprojected into
    the query; with max_obs below the candidate's observation count the even
    subsample across its run is taken."""
    tm, jm = maps
    a, b = 11, 2
    T_ab = np.linalg.inv(n(jm.kf_pose[a])) @ n(jm.kf_pose[b])
    want = jloop._verify_world(
        jm, jm.kf_desc[a], jm.kf_xy[a], jm.kf_has_point[a], jnp.int32(b),
        jnp.asarray(T_ab), jnp.asarray(INTR), window, max_obs)
    got = tloop._verify_world(
        tm, tm.kf_desc[a], tm.kf_xy[a], tm.kf_has_point[a], torch.tensor(b),
        t(T_ab), t(INTR), window, max_obs)
    assert int(got) == int(want) > 20
    assert got.dtype == torch.int32


def test_retrieve_and_verify_over_keyframes_with_the_gate_carried(maps):
    """At every keyframe slot in turn, with the consistency gate's state
    carried from one keyframe to the next, the decision's five outputs agree;
    the gate opens once the streak is long enough."""
    tm, jm = maps
    jcfg, tcfg = JLoopConfig(**LOOP), LoopClosureConfig(**LOOP)
    assert jcfg == JLoopConfig(**tcfg.__dict__)
    prev_uid, consist = tloop.NO_CANDIDATE_UID, 0
    fired = 0
    for slot in range(2, N_KF):
        key = jax.random.PRNGKey(100 + slot)
        want = jloop.retrieve_and_verify(
            jm, jnp.int32(slot), key, jcfg, jnp.asarray(INTR),
            jnp.int32(prev_uid), jnp.int32(consist))
        cands = jloop.retrieve_topn(jm, jnp.int32(slot), jcfg.min_sim,
                                    jcfg.min_kf_gap, jcfg.topn)
        keys = jax.random.split(key, jcfg.topn)
        idx = np.stack([
            _jax_samples(keys[c], _pair_weights(jm, slot, int(cands.kf_idx[c])))
            for c in range(jcfg.topn)])
        got = tloop.retrieve_and_verify(
            tm, slot, None, tcfg, t(INTR), prev_uid, consist,
            sample_idx=t(idx), device="cpu")
        assert int(got[0]) == int(want[0]), slot
        close(n(got[1]), n(want[1]), rtol=0, atol=1e-4)
        assert bool(got[2]) == bool(want[2]), slot
        assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4]), slot
        assert got[3].dtype == got[4].dtype == torch.int32
        prev_uid, consist = int(want[3]), int(want[4])
        fired += bool(want[2])
    assert fired >= 3 and consist >= 2


def test_close_matches_on_a_map_built_by_the_jax_package(maps):
    _, jm = maps
    # drift: later keyframes slide away, so the loop edge has work to do
    fields = jax_map_to_numpy(jm)
    for k in range(N_KF):
        fields["kf_pose"][k, :3, 3] += np.float32([0.004, 0.0, 0.006]) * k * k / 4
    jm = jm._replace(kf_pose=jnp.asarray(fields["kf_pose"]))
    tm = convert.map_state_from_numpy(fields, "cpu")
    T_ab = (np.linalg.inv(n(maps[1].kf_pose[11])) @ n(maps[1].kf_pose[1]))
    jpg, tpg = JPoseGraphConfig(), PoseGraphConfig()
    want = jloop.close(jm, jnp.int32(11), jnp.int32(1), jnp.asarray(T_ab), jpg)
    got = tloop.close(tm, 11, torch.tensor(1), t(T_ab), tpg, device="cpu")
    # 20 Gauss-Newton steps on a 96 x 96 system in f32: poses 1e-4; landmarks
    # ride a pose product: 1e-3
    assert_maps_equal(got, want, float_atol={"kf_pose": 1e-4, "lm_pos": 1e-3})
    assert int(got.num_loop) == 1 and bool(got.loop_valid[0])
    moved = np.abs(n(got.kf_pose) - fields["kf_pose"]).max()
    assert moved > 0.02
    again = tloop.close(tm, 11, 1, t(T_ab), tpg, device="cpu")
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    # a second edge lands in the next ring slot and both are re-applied
    T_cd = np.linalg.inv(n(maps[1].kf_pose[10])) @ n(maps[1].kf_pose[0])
    want2 = jloop.close(want, jnp.int32(10), jnp.int32(0), jnp.asarray(T_cd), jpg)
    got2 = tloop.close(got, 10, 0, t(T_cd), tpg, device="cpu")
    assert_maps_equal(got2, want2, float_atol={"kf_pose": 2e-4, "lm_pos": 2e-3})
    assert int(got2.num_loop) == 2 and bool(got2.loop_valid[1])
