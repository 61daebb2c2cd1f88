"""Keyframe map store and windowed BA of the PyTorch port vs the JAX package
(CPU): the same numpy feature sets go through both, step by step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import MapConfig as JMapConfig
from jetracer_orbslam2_tpu.config import SystemConfig as JSystemConfig
from jetracer_orbslam2_tpu.models import slam as jslam
from jetracer_orbslam2_tpu.models.backend import map as jmap

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import MapConfig, SystemConfig
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models.backend import map as tmap

from _torch_port_util import (
    INTR, K, SMALL, assert_maps_equal as _assert_maps_equal,
    build_maps as _build, frame as _frame, jfeats as _jfeats, n,
    pose as _pose, world as _world)

close = np.testing.assert_allclose


def test_init_map_field_by_field():
    jm = jmap.init_map(JMapConfig(**SMALL), K)
    tm = tmap.init_map(MapConfig(**SMALL), K, device="cpu")
    assert tm._fields == jm._fields
    _assert_maps_equal(tm, jm, atol=0)
    assert tm.kf_desc.dtype == torch.int32 and tm.num_kf.dim() == 0


def test_global_descriptor_matches():
    f = _frame(_world(3), 0, 5)
    want = jmap.global_descriptor(jnp.asarray(f["desc"]), jnp.asarray(f["valid"]))
    got = tmap.global_descriptor(convert.desc_from_numpy(f["desc"], "cpu"),
                                 torch.from_numpy(f["valid"]))
    # a mean of 0/1 values over <= 128 keypoints: exact up to the division
    close(n(got), np.asarray(want), rtol=0, atol=1e-7)
    none = tmap.global_descriptor(convert.desc_from_numpy(f["desc"], "cpu"),
                                  torch.zeros(K, dtype=torch.bool))
    assert float(none.abs().max()) == 0.0


def test_associate_and_insert_keyframes_match_step_by_step():
    tm, jm = _build(SMALL, 5)
    assert int(tm.num_kf) == 5
    assert int(tm.num_lm) > 110        # later frames added landmarks too
    assert int(tm.num_obs) > int(tm.num_lm)   # and re-observations of old ones


def test_insert_keyframe_leaves_its_argument_untouched():
    world = _world(0)
    tm = tmap.init_map(MapConfig(**SMALL), K, device="cpu")
    before = convert.map_state_to_numpy(tm)
    f = convert.features_from_numpy(_frame(world, 0, 100), "cpu")
    tmap.insert_keyframe(tm, f, torch.eye(4), 0, f.has_point,
                         torch.zeros(K, dtype=torch.int32),
                         torch.zeros(K, dtype=torch.bool), device="cpu")
    after = convert.map_state_to_numpy(tm)
    for name in before:
        np.testing.assert_array_equal(before[name], after[name], err_msg=name)


def test_insert_keyframe_overflow_of_landmarks_observations_and_keyframes():
    """Capacities smaller than two frames' worth: the overflowing landmarks
    and observations are dropped, and a keyframe beyond the last slot changes
    nothing but is reported at the clamped slot."""
    tight = dict(max_keyframes=2, max_landmarks=150, max_obs=140)
    world_a, world_b = _world(1), _world(2)        # unrelated scenes
    jm = jmap.init_map(JMapConfig(**tight), K)
    tm = tmap.init_map(MapConfig(**tight), K, device="cpu")
    no_idx, no_ok = np.zeros(K, np.int32), np.zeros(K, bool)
    for i, world in enumerate((world_a, world_b, world_a)):
        f = _frame(world, i, 200 + i)
        jm_prev = jm
        jm, j_slot = jmap.insert_keyframe(
            jm, _jfeats(f), jnp.asarray(_pose(i)), jnp.int32(i),
            jnp.asarray(f["has_point"]), jnp.asarray(no_idx), jnp.asarray(no_ok))
        tm, t_slot = tmap.insert_keyframe(
            tm, convert.features_from_numpy(f, "cpu"),
            torch.from_numpy(_pose(i)), i, torch.from_numpy(f["has_point"]),
            torch.from_numpy(no_idx), torch.from_numpy(no_ok), device="cpu")
        assert int(t_slot) == int(j_slot) == min(i, 1)
        if i == 1:
            # The last slot of each table is the one target that several
            # keypoints share when the table overflows.  The JAX package
            # lets the overflowing keypoints rewrite the slot's old row over
            # the one landmark (observation) that did fit; the port writes
            # each kept row exactly once.  Everything else is bit-equal.
            last = {name: [149] for name in
                    ("lm_pos", "lm_desc", "lm_valid", "lm_ref_kf")}
            last.update({name: [139] for name in
                         ("obs_kf", "obs_lm", "obs_uv", "obs_z", "obs_valid")})
            _assert_maps_equal(tm, jm, skip_rows=last)
            assert int(tm.num_lm) == 150 and int(tm.num_obs) == 140
            assert bool(tm.lm_valid[149]) and bool(tm.obs_valid[139])
            assert int(tm.obs_lm[139]) < 150
            # carry on from one common state
            jm = jm_prev._replace(**{
                k: jnp.asarray(v) for k, v in
                convert.map_state_to_numpy(tm).items()})
        else:
            _assert_maps_equal(tm, jm)
    assert int(tm.num_kf) == 2


def test_compact_map_matches():
    tm, jm = _build(SMALL, 6, check=False)
    _assert_maps_equal(tm, jm)
    jc = jmap.compact_map(jm, jnp.float32(5), jnp.int32(2))
    tc = tmap.compact_map(tm, 5, 2, device="cpu")
    _assert_maps_equal(tc, jc)
    assert int(tc.num_lm) < int(tm.num_lm)      # something was culled
    assert int(tc.num_obs) < int(tm.num_obs)
    # tensor arguments are taken too, and nothing is culled below the age
    tc2 = tmap.compact_map(tm, torch.tensor(2.0), torch.tensor(100),
                           device="cpu")
    assert int(tc2.num_lm) == int(tm.num_lm)


@pytest.mark.parametrize("n_kf,window,cull_singles", [
    (6, 4, True), (3, 4, True), (3, 4, False)])
def test_local_ba_matches(n_kf, window, cull_singles):
    """Windowed BA over the newest keyframes of a small map, with fewer
    keyframes than the window too (repeated, gauge-fixed slots).  Against the
    JAX package's dense route: poses to 1e-4, landmarks to 1e-3 after 5 LM
    iterations in f32, for the port's dense route and for its fused route.

    A landmark with exactly one observation in the window is frozen, but its
    cross block still enters the Schur complement (with the identity for
    Hll^-1), in both packages; the reduced system is then indefinite and
    every step is rejected.  So the map is compacted first (landmarks seen
    once are culled) where the BA is expected to move something, and left as
    it is in one case, where both packages must leave the map alone."""
    tm, jm = _build(SMALL, n_kf, check=False)
    if cull_singles:
        tm = tmap.compact_map(tm, 2, 0, device="cpu")
        jm = jmap.compact_map(jm, jnp.float32(2), jnp.int32(0))
        _assert_maps_equal(tm, jm)
    # disturb the newer keyframe poses so that BA has work to do
    rng = np.random.default_rng(9)
    kf_pose = convert.map_state_to_numpy(tm)["kf_pose"].copy()
    kf_pose[1:n_kf, :3, 3] += rng.normal(0, 0.02, (n_kf - 1, 3)).astype(np.float32)
    tm = tm._replace(kf_pose=torch.from_numpy(kf_pose))
    jm = jm._replace(kf_pose=jnp.asarray(kf_pose))

    jcfg = JSystemConfig()
    jcfg = jcfg.replace(ba=jcfg.ba.__class__(iters=5))
    tcfg = SystemConfig()
    tcfg = tcfg.replace(ba=tcfg.ba.__class__(iters=5))
    jout = jslam.local_ba(jm, jnp.asarray(INTR), window, jcfg)
    tout = tslam.local_ba(tm, torch.from_numpy(INTR), window, tcfg,
                          fused=False, device="cpu")
    tfused = tslam.local_ba(tm, torch.from_numpy(INTR), window, tcfg,
                            fused=True, device="cpu")
    first = max(n_kf - window, 0)
    for out in (tout, tfused):
        close(n(out.kf_pose), np.asarray(jout.kf_pose), rtol=0, atol=1e-4)
        close(n(out.lm_pos), np.asarray(jout.lm_pos), rtol=0, atol=1e-3)
        # the oldest window pose is the gauge: untouched but for the f32
        # round trip through two pose inversions
        close(n(out.kf_pose[first]), kf_pose[first], rtol=0, atol=1e-6)
        for name in tm._fields:
            if name not in ("kf_pose", "lm_pos"):
                assert torch.equal(getattr(out, name), getattr(tm, name)), name
    moved = np.abs(n(tout.kf_pose) - kf_pose).max()
    assert (moved > 1e-3) if cull_singles else (moved < 1e-6), moved
