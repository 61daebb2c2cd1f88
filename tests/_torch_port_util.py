"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: both sides get the same numpy inputs; JAX runs on the CPU as in its
own tests, the port runs with device="cpu"."""

import jax.numpy as jnp
import numpy as np
import torch

from jetracer_orbslam2_tpu.config import MapConfig as JMapConfig
from jetracer_orbslam2_tpu.models.backend import map as jmap
from jetracer_orbslam2_tpu.models.frontend import Features as JFeatures

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import MapConfig
from jetracer_orbslam2_torch.models.backend import map as tmap

# The tests' tensors are small: a pool of intra-op threads in every test
# worker only fights the other workers for the cores.
torch.set_num_threads(1)

FEATURE_FIELDS = ("xy", "level", "score", "angle", "desc", "valid",
                  "points", "has_point")


def t(a, dtype=None):
    """numpy -> CPU tensor (copying, so neither side sees the other's edits)."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def image_u8(shape, seed=0):
    """Integer-valued f32 image: every blur/pyramid intermediate of the first
    two levels is exactly representable, so no summation order can differ."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape).astype(np.float32)


def jax_features_to_numpy(feats) -> dict:
    """JAX `Features` -> dict of numpy arrays (desc stays uint32)."""
    return {name: np.asarray(getattr(feats, name)) for name in FEATURE_FIELDS}


def assert_maps_equal(tm, jm, skip_rows=None, atol=1e-6, float_atol=None):
    """The port's `MapState` against the JAX package's, field by field:
    integer and boolean fields bit for bit, float fields to `atol` (or to
    `float_atol[name]` where given).  `skip_rows` maps a field name to rows
    left out of the comparison."""
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
            tol = (float_atol or {}).get(name, atol)
            np.testing.assert_allclose(g, want, rtol=0, atol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, want, err_msg=name)


def jax_map_from_numpy(fields):
    """Dict of numpy arrays keyed by `MapState` field name -> the JAX
    package's `MapState`."""
    return jmap.MapState(
        **{k: jnp.asarray(fields[k]) for k in jmap.MapState._fields})


def jax_map_to_numpy(jm) -> dict:
    return {k: np.array(getattr(jm, k)) for k in jm._fields}


# A synthetic world seen from an arc of camera poses: numpy feature sets that
# both packages insert into their maps, keyframe by keyframe.
K = 128
INTR = np.float32([300.0, 300.0, 160.0, 120.0])
SMALL = dict(max_keyframes=8, max_landmarks=512, max_obs=2048)


def pose(i):
    """Camera pose of synthetic keyframe i: a gentle arc."""
    T = np.eye(4, dtype=np.float32)
    a = 0.03 * i
    T[0, 0] = T[2, 2] = np.cos(a)
    T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
    T[:3, 3] = [0.12 * i, 0.01 * i, 0.02 * i]
    return T


def world(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.6, -1.2, 2.5], [2.2, 1.2, 6.0], (K, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint64).astype(np.uint32)
    return pts, desc


def frame(scene, i, seed):
    """What a camera at `pose(i)` sees of the world: a numpy feature dict."""
    pts_w, desc = scene
    rng = np.random.default_rng(seed)
    T_cw = np.linalg.inv(pose(i))
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


def jfeats(fields):
    return JFeatures(**{k: jnp.asarray(fields[k]) for k in FEATURE_FIELDS})


def build_maps(cfg_kwargs, n_kf, world_seed=0, check=True):
    """Run associate + insert for n_kf keyframes through both packages."""
    scene = world(world_seed)
    jm = jmap.init_map(JMapConfig(**cfg_kwargs), K)
    tm = tmap.init_map(MapConfig(**cfg_kwargs), K, device="cpu")
    for i in range(n_kf):
        f = frame(scene, i, 100 + i)
        jf, tf = jfeats(f), convert.features_from_numpy(f, "cpu")
        T = pose(i)
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
            assert_maps_equal(tm, jm)
    return tm, jm


