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
from jetracer_orbslam2_tpu.models.frontend import Features as JFeatures

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import MapConfig, SystemConfig
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models.backend import map as tmap

from _torch_port_util import FEATURE_FIELDS, n

close = np.testing.assert_allclose

K = 128
INTR = np.float32([300.0, 300.0, 160.0, 120.0])
SMALL = dict(max_keyframes=8, max_landmarks=512, max_obs=2048)


def _pose(i):
    T = np.eye(4, dtype=np.float32)
    a = 0.03 * i
    T[0, 0] = T[2, 2] = np.cos(a)
    T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
    T[:3, 3] = [0.12 * i, 0.01 * i, 0.02 * i]
    return T


def _world(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.6, -1.2, 2.5], [2.2, 1.2, 6.0], (K, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint64).astype(np.uint32)
    return pts, desc


def _frame(world, i, seed):
    """What a camera at `_pose(i)` sees of the world: a numpy feature dict."""
    pts_w, desc = world
    rng = np.random.default_rng(seed)
    T_cw = np.linalg.inv(_pose(i))
    pc = (pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]).astype(np.float32)
    xy = pc[:, :2] / pc[:, 2:3] * INTR[:2] + INTR[2:]
    xy = (xy + rng.normal(0, 0.3, xy.shape)).astype(np.float32)
    valid = rng.random(K) > 0.1
    has_point = valid & (rng.random(K) > 0.15)
    flip = np.zeros((K, 8), np.uint32)
    flip[:, rng.integers(0, 8)] = np.uint32(1) << np.uint32(rng.integers(0, 32))
    order = rng.permutation(K)          # keypoint order differs per frame
    fields = dict(
        xy=xy, level=np.zeros(K, np.int32),
        score=rng.random(K).astype(np.float32),
        angle=np.zeros(K, np.float32), desc=desc ^ flip, valid=valid,
        points=np.where(has_point[:, None], pc, 0).astype(np.float32),
        has_point=has_point)
    return {k: v[order] for k, v in fields.items()}


def _jfeats(fields):
    return JFeatures(**{k: jnp.asarray(fields[k]) for k in FEATURE_FIELDS})


def _assert_maps_equal(tm, jm, skip_rows=None, atol=1e-6):
    """Field by field: integer and boolean fields bit for bit, float fields
    to `atol` (world points are one 3x3 product + translation in f32)."""
    got = convert.map_state_to_numpy(tm)
    for name in jm._fields:
        want = np.asarray(getattr(jm, name))
        g = got[name]
        assert g.shape == want.shape and g.dtype == want.dtype, name
        if skip_rows and name in skip_rows:
            keep = np.ones(g.shape[0], bool)
            keep[skip_rows[name]] = False
            g, want = g[keep], want[keep]
        if np.issubdtype(want.dtype, np.floating):
            close(g, want, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, want, err_msg=name)


def _build(cfg_kwargs, n_kf, world_seed=0, check=True):
    """Run associate + insert for n_kf keyframes through both packages."""
    world = _world(world_seed)
    jm = jmap.init_map(JMapConfig(**cfg_kwargs), K)
    tm = tmap.init_map(MapConfig(**cfg_kwargs), K, device="cpu")
    for i in range(n_kf):
        f = _frame(world, i, 100 + i)
        jf, tf = _jfeats(f), convert.features_from_numpy(f, "cpu")
        T = _pose(i)
        j_idx, j_ok = jmap.associate_landmarks(jm, jf, jnp.asarray(T),
                                               jnp.asarray(INTR))
        t_idx, t_ok = tmap.associate_landmarks(tm, tf, torch.from_numpy(T),
                                               torch.from_numpy(INTR),
                                               device="cpu")
        if check:
            np.testing.assert_array_equal(n(t_ok), np.asarray(j_ok))
            np.testing.assert_array_equal(n(t_idx), np.asarray(j_idx))
            assert t_idx.dtype == torch.int32
        new_mask = f["has_point"] & ~np.asarray(j_ok)
        jm, j_slot = jmap.insert_keyframe(
            jm, jf, jnp.asarray(T), jnp.int32(10 * i), jnp.asarray(new_mask),
            j_idx, j_ok)
        tm, t_slot = tmap.insert_keyframe(
            tm, tf, torch.from_numpy(T), 10 * i, torch.from_numpy(new_mask),
            t_idx, t_ok, device="cpu")
        if check:
            assert int(t_slot) == int(j_slot)
            _assert_maps_equal(tm, jm)
    return tm, jm


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
