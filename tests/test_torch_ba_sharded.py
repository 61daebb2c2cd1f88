"""Landmark-sharded BA of the PyTorch port (`parallel/mesh.py`,
`parallel/ba_sharded.py`, `bench_ba.time_sharded_ba` / `measure_scaling`) on
the CPU, held to the port's unsharded solver (a one-rank gloo group: bit for
bit) and to the JAX package's `sharded_bundle_adjust` / `sharded_local_ba`
on the conftest's virtual CPU devices, with the JAX tests' sizes and bars
(`tests/test_ba_sharded.py`)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from jetracer_orbslam2_tpu.config import BAConfig as JBAConfig
from jetracer_orbslam2_tpu.config import MapConfig as JMapConfig
from jetracer_orbslam2_tpu.config import SystemConfig as JSystemConfig
from jetracer_orbslam2_tpu.models.backend import map as jmap
from jetracer_orbslam2_tpu.parallel import make_mesh as j_make_mesh
from jetracer_orbslam2_tpu.parallel import (
    prepare_sharded_problem as j_prepare, sharded_bundle_adjust as j_sba,
    sharded_local_ba as j_slba)
from jetracer_orbslam2_tpu.parallel.bench_ba import (
    make_synthetic_ba as j_make_synthetic_ba)

from jetracer_orbslam2_torch.config import BAConfig, MapConfig, SystemConfig
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models.backend import map as tmap
from jetracer_orbslam2_torch.models.backend.ba import bundle_adjust
from jetracer_orbslam2_torch.parallel import (
    init_distributed, make_mesh, map_mesh, prepare_sharded_problem,
    sharded_bundle_adjust, sharded_local_ba, virtual_mesh)
from jetracer_orbslam2_torch.parallel.bench_ba import (
    make_synthetic_ba, measure_scaling, time_sharded_ba)

from _torch_port_util import n

# small tensors only: see tests/_torch_port_util.py
torch.set_num_threads(1)

close = np.testing.assert_allclose


@pytest.fixture
def mesh():
    """A one-rank gloo group on the CPU, destroyed at teardown."""
    assert not dist.is_initialized()
    m = make_mesh(device="cpu")
    yield m
    m.close()
    assert not dist.is_initialized()


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_prepare_sharded_problem_matches_jax(n_dev):
    # L = 61 pads to a multiple of every mesh size but 1
    jprob, _ = j_make_synthetic_ba(6, 61, 4)
    tprob, _ = make_synthetic_ba(6, 61, 4, device="cpu")
    js = j_prepare(jprob, n_dev)
    ts = prepare_sharded_problem(tprob, n_dev, device="cpu")
    assert ts.points.shape[0] == -(-61 // n_dev) * n_dev
    for name in js._fields:
        a, b = np.asarray(getattr(js, name)), n(getattr(ts, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_one_rank_mesh_equals_bundle_adjust(mesh, fused):
    """The n = 1 group runs the identical program: poses, points and trace
    `torch.equal` to `bundle_adjust` (fused=True: the kernels' plain
    versions on the CPU)."""
    prob, intr = make_synthetic_ba(6, 64, 4, device="cpu")
    cfg = BAConfig(iters=8)
    p1, x1, stats = bundle_adjust(prob, intr, cfg, fused=fused, device="cpu")
    sprob = prepare_sharded_problem(prob, 1, device="cpu")
    p2, x2, trace = sharded_bundle_adjust(sprob, intr, cfg, mesh, fused=fused)
    assert mesh.size == 1 and mesh.backend == "gloo"
    assert torch.equal(p1, p2) and torch.equal(x1, x2)
    assert torch.equal(stats.cost, trace)
    assert float(trace[-1]) < 0.2 * float(trace[0])


def _hand_built_maps(point_noise=0.08):
    """The JAX test's hand-built map (6 keyframes, 512 landmarks seen 4
    times), in both packages."""
    jprob, intr = j_make_synthetic_ba(n_poses=6, n_landmarks=512, obs_per_lm=4,
                                      point_noise=point_noise)
    kw = dict(max_keyframes=8, max_landmarks=512, max_obs=512 * 4,
              window_size=6)
    jm = jmap.init_map(JMapConfig(**kw), num_keypoints=64)
    E = jprob.obs_kf.shape[0]
    jm = jm._replace(
        kf_pose=jm.kf_pose.at[:6].set(jprob.poses),
        kf_valid=jm.kf_valid.at[:6].set(True),
        lm_pos=jprob.points, lm_valid=jnp.ones(512, bool),
        obs_kf=jprob.obs_kf, obs_lm=jprob.obs_lm, obs_uv=jprob.obs_uv,
        obs_z=jprob.obs_z, obs_valid=jnp.ones(E, bool),
        num_kf=jnp.int32(6), num_lm=jnp.int32(512), num_obs=jnp.int32(E))
    tm = tmap.init_map(MapConfig(**kw), 64, device="cpu")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tm = tm._replace(
        kf_pose=t(jm.kf_pose), kf_valid=t(jm.kf_valid), lm_pos=t(jm.lm_pos),
        lm_valid=t(jm.lm_valid), obs_kf=t(jm.obs_kf), obs_lm=t(jm.obs_lm),
        obs_uv=t(jm.obs_uv), obs_z=t(jm.obs_z), obs_valid=t(jm.obs_valid),
        num_kf=t(jm.num_kf), num_lm=t(jm.num_lm), num_obs=t(jm.num_obs))
    jcfg = JSystemConfig(map=JMapConfig(**kw), ba=JBAConfig(iters=8))
    tcfg = SystemConfig(map=MapConfig(**kw), ba=BAConfig(iters=8))
    return jm, tm, np.array(intr), jcfg, tcfg


def test_one_rank_mesh_equals_local_ba(mesh):
    _, tm, intr, _, cfg = _hand_built_maps()
    m1 = tslam.local_ba(tm, intr, 6, cfg, device="cpu")
    m2, dropped = sharded_local_ba(tm, intr, 6, cfg, mesh)
    assert int(dropped) == 0
    for a, b in zip(m1, m2):
        assert torch.equal(a, b)
    assert float((m2.lm_pos - tm.lm_pos).norm(dim=1).mean()) > 1e-4


@pytest.mark.parametrize("n_dev", [1, 8])
def test_sharded_solve_matches_jax(mesh, n_dev):
    """The port's sharded solve against the JAX package's on an n-device
    mesh of virtual CPU devices (`tests/test_ba_sharded.py`'s bars)."""
    jprob, jintr = j_make_synthetic_ba(6, 64, 4)
    cfg = BAConfig(iters=8)
    jp, jx, jt = j_sba(j_prepare(jprob, n_dev), jintr, JBAConfig(iters=8),
                       j_make_mesh(n_dev))
    tprob, intr = make_synthetic_ba(6, 64, 4, device="cpu")
    tp, tx, tt = sharded_bundle_adjust(
        prepare_sharded_problem(tprob, 1, device="cpu"), intr, cfg, mesh)
    close(n(tp), np.asarray(jp), rtol=0, atol=5e-3)
    close(n(tx), np.asarray(jx)[:64], rtol=0, atol=2e-2)
    close(n(tt), np.asarray(jt), rtol=5e-3)
    assert float(tt[-1]) < 0.2 * float(tt[0])


def test_sharded_local_ba_matches_jax(mesh):
    jm, tm, intr, jcfg, cfg = _hand_built_maps()
    jm2, jdrop = j_slba(jm, jnp.asarray(intr), 6, jcfg, j_make_mesh(8))
    tm2, tdrop = sharded_local_ba(tm, intr, 6, cfg, mesh)
    assert int(jdrop) == int(tdrop) == 0
    close(n(tm2.kf_pose), np.asarray(jm2.kf_pose), rtol=0, atol=5e-3)
    close(n(tm2.lm_pos), np.asarray(jm2.lm_pos), rtol=0, atol=2e-2)


def test_fused_route_plain_versions_match_dense(mesh):
    """`fused=True` on the CPU runs K2/K3's plain versions on the rank's
    block with the pose-sized sums all-reduced: the dense route's results
    (`tests/test_ba_sharded.py::test_sharded_fused_pallas_matches_sharded_xla`)."""
    prob, intr = make_synthetic_ba(n_poses=8, n_landmarks=128, obs_per_lm=5,
                                   device="cpu")
    sprob = prepare_sharded_problem(prob, 1, device="cpu")
    cfg = BAConfig(iters=4)
    p1, x1, t1 = sharded_bundle_adjust(sprob, intr, cfg, mesh, fused=False)
    p2, x2, t2 = sharded_bundle_adjust(sprob, intr, cfg, mesh, fused=True)
    close(n(t2), n(t1), rtol=5e-3)
    assert float((p1 - p2).abs().max()) < 5e-3
    assert float((x1 - x2).abs().max()) < 2e-2


def test_init_distributed_with_nothing_set_returns_false(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized()


def test_meshes_that_do_not_fit_raise(mesh):
    _, tm, intr, _, cfg = _hand_built_maps()
    three = types.SimpleNamespace(size=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="L=512 n=3"):
        sharded_local_ba(tm, intr, 6, cfg, three)
    with pytest.raises(ValueError, match="joined group has 1"):
        make_mesh(4, device="cpu")
    assert map_mesh(mesh) is mesh
    again = virtual_mesh(1, device="cpu")
    assert again.size == 1 and not again.owns_group
    again.close()
    assert dist.is_initialized()            # the fixture's group stays up


def test_mesh_never_falls_back_to_the_cpu():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torch.distributed.run"):
        make_mesh(2, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    for call in (make_mesh, lambda: virtual_mesh(1), map_mesh,
                 lambda: init_distributed("file:///nonexistent", 1, 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not dist.is_initialized()


def test_time_sharded_ba_and_measure_scaling_on_the_cpu():
    prob, intr = make_synthetic_ba(4, 64, 4, device="cpu")
    row = time_sharded_ba(prob, intr, 1, BAConfig(iters=3), reps=1,
                          device="cpu")
    assert not dist.is_initialized()       # the one-rank group was its own
    assert row["n"] == 1 and row["ms_per_iter"] > 0 and row["cost_drop"] > 1
    rows = measure_scaling((1, 2), n_poses=4, n_landmarks=64, obs_per_lm=4,
                           iters=3, reps=1, device="cpu")
    assert [r["n"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["ms_per_iter"] > 0 and r["cost_drop"] > 1 for r in rows)
