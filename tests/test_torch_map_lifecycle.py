"""Keyframe culling and slot recycling of the PyTorch port vs the JAX package
(CPU): the cases of `tests/test_map_lifecycle.py`, the same numpy map through
`compact_keyframes` of both packages.  Integer and boolean fields must agree
bit for bit; poses, `dead_rel` and `loop_T` (a few 4x4 products in f32) to
1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import MapConfig as JMapConfig
from jetracer_orbslam2_tpu.models.backend import map as jmap

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.models.backend import map as tmap

from _torch_port_util import (
    assert_maps_equal, jax_map_from_numpy, jax_map_to_numpy)

POSE_TOL = {"kf_pose": 1e-5, "dead_rel": 1e-5, "loop_T": 1e-5}


def _pose(i):
    """A pose with a rotation, so that relative poses are not translations."""
    a = 0.2 * i
    T = np.eye(4, dtype=np.float32)
    T[0, 0] = T[2, 2] = np.cos(a)
    T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
    T[:3, 3] = [float(i), 0.1 * i, -0.05 * i * i]
    return T


def _kf_toy_map(max_dead=16, num_dead=0):
    """6 keyframes; landmarks 0/1/3 covisible from 4-5 keyframes, landmark 2
    from only 2: keyframes 1 and 2 are fully redundant, keyframe 3 is not
    (the toy map of tests/test_map_lifecycle.py, with rotated poses)."""
    f = jax_map_to_numpy(jmap.init_map(
        JMapConfig(max_keyframes=8, max_landmarks=8, max_obs=32,
                   max_dead_keyframes=max_dead), num_keypoints=4))
    obs = sorted([(0, 0), (1, 0), (2, 0), (3, 0), (4, 0),
                  (0, 1), (1, 1), (2, 1), (4, 1),
                  (3, 2), (5, 2),
                  (2, 3), (0, 3), (1, 3), (4, 3)], key=lambda o: o[0])
    E = len(obs)
    f["kf_valid"][:6] = True
    for i in range(6):
        f["kf_pose"][i] = _pose(i)
    f["kf_frame_id"][:6] = [0, 5, 10, 15, 20, 25]
    f["kf_global_desc"][:6] = np.random.default_rng(0).random((6, 256), np.float32)
    f["lm_valid"][:4] = True
    f["lm_ref_kf"][:4] = [0, 1, 2, 3]
    f["obs_kf"][:E] = [o[0] for o in obs]
    f["obs_lm"][:E] = [o[1] for o in obs]
    f["obs_uv"][:E] = np.arange(2 * E, dtype=np.float32).reshape(E, 2)
    f["obs_z"][:E] = 1.0 + np.arange(E, dtype=np.float32)
    f["obs_valid"][:E] = True
    f["num_kf"], f["num_lm"], f["num_obs"] = (
        np.int32(6), np.int32(4), np.int32(E))
    f["num_dead"] = np.int32(num_dead)
    return f


def _with_loop_edges(f):
    # edge A between the two redundant keyframes 1 and 2; edge B from the
    # redundant keyframe 1 to the kept keyframe 3
    f["loop_i"][:2] = [1, 1]
    f["loop_j"][:2] = [2, 3]
    f["loop_T"][0] = np.linalg.inv(_pose(1)) @ _pose(2)
    f["loop_T"][1] = np.linalg.inv(_pose(1)) @ _pose(3)
    f["loop_valid"][:2] = True
    f["num_loop"] = np.int32(2)
    return f


def _strip_kf3(f):
    """Keyframe 3 loses its observations; the list is packed again, as
    `compact_map` would leave it."""
    keep = f["obs_valid"] & (f["obs_kf"] != 3)
    order = np.argsort(~keep, kind="stable")
    n = int(keep.sum())
    for name in ("obs_kf", "obs_lm", "obs_uv", "obs_z", "obs_valid"):
        f[name] = f[name][order]
        f[name][n:] = 0
    f["num_obs"] = np.int32(n)
    return f


def _both(f, *args):
    jm = jax_map_from_numpy(f)
    tm = convert.map_state_from_numpy(f, "cpu")
    jargs = (jnp.float32(args[0]),) + tuple(jnp.int32(a) for a in args[1:])
    return tmap.compact_keyframes(tm, *args, device="cpu"), \
        jmap.compact_keyframes(jm, *jargs)


def _check_obs_prefix(m):
    ok = m.obs_valid.numpy()
    no = int(m.num_obs)
    assert ok[:no].all() and not ok[no:].any()
    assert (np.diff(m.obs_kf.numpy()[:no]) >= 0).all(), "obs_kf prefix not sorted"


CASES = {
    "redundant_cull": (_kf_toy_map(), (0.9, 3, 2, 8), 4),
    "forced_cull_under_target": (_kf_toy_map(), (2.0, 3, 2, 3), 3),
    "loop_edges_protected": (_with_loop_edges(_kf_toy_map()), (0.9, 3, 2, 8, 8), 6),
    "loop_edges_retire_onto_anchor": (
        _with_loop_edges(_kf_toy_map()), (0.9, 3, 2, 8, 0), 4),
    "zero_observation_keyframe": (_strip_kf3(_kf_toy_map()), (0.9, 3, 2, 8), 3),
    "ring_wrap_around": (_kf_toy_map(max_dead=2, num_dead=5), (0.9, 3, 2, 8), 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_keyframes_matches(case):
    fields, args, num_kf = CASES[case]
    tm, jm = _both({k: np.array(v) for k, v in fields.items()}, *args)
    assert int(tm.num_kf) == int(jm.num_kf) == num_kf
    assert_maps_equal(tm, jm, float_atol=POSE_TOL)
    _check_obs_prefix(tm)
    assert int(tm.num_obs) == int(tm.obs_valid.sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolve_kf_poses_matches(case):
    fields, args, _ = CASES[case]
    tm, jm = _both({k: np.array(v) for k, v in fields.items()}, *args)
    got, want = tmap.resolve_kf_poses(tm), jmap.resolve_kf_poses(jm)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_allclose(got[uid], want[uid], rtol=0, atol=1e-5)
    if case != "ring_wrap_around":
        # every keyframe ever inserted still resolves, at its own pose
        assert sorted(got) == [0, 5, 10, 15, 20, 25]
        for i, uid in enumerate([0, 5, 10, 15, 20, 25]):
            np.testing.assert_allclose(got[uid], _pose(i), rtol=0, atol=1e-5)


def test_loop_edge_retires_onto_the_anchor():
    """The edge (1 -> 3) of a culled keyframe 1 becomes (0 -> new slot of 3)
    with the measurement composed through the culled->anchor offset, and the
    edge between the two culled keyframes collapses and is dropped."""
    fields, args, _ = CASES["loop_edges_retire_onto_anchor"]
    tm, _ = _both({k: np.array(v) for k, v in fields.items()}, *args)
    assert not bool(tm.loop_valid[0]) and bool(tm.loop_valid[1])
    assert (int(tm.loop_i[1]), int(tm.loop_j[1])) == (0, 1)
    np.testing.assert_allclose(
        tm.loop_T[1].numpy(), np.linalg.inv(_pose(0)) @ _pose(3), atol=1e-5)


def test_compact_keyframes_then_compact_map_and_insert_again():
    """After a bare `compact_keyframes` the freed slots are reusable: the
    following `compact_map` keeps the sorted prefix, in both packages."""
    fields, args, _ = CASES["redundant_cull"]
    tm, jm = _both({k: np.array(v) for k, v in fields.items()}, *args)
    tm = tmap.compact_map(tm, 1, 0, device="cpu")
    jm = jmap.compact_map(jm, jnp.float32(1), jnp.int32(0))
    assert_maps_equal(tm, jm, float_atol=POSE_TOL)
    _check_obs_prefix(tm)


def test_compact_keyframes_leaves_its_argument_untouched_and_is_repeatable():
    fields = {k: np.array(v) for k, v in CASES["loop_edges_retire_onto_anchor"][0].items()}
    tm = convert.map_state_from_numpy(fields, "cpu")
    a = tmap.compact_keyframes(tm, 0.9, 3, 2, 8, 0, device="cpu")
    b = tmap.compact_keyframes(tm, torch.tensor(0.9), torch.tensor(3),
                               torch.tensor(2), torch.tensor(8), 0, device="cpu")
    after = convert.map_state_to_numpy(tm)
    for name, value in fields.items():
        np.testing.assert_array_equal(after[name], value, err_msg=name)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
