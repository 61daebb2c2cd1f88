"""One captured graph per configuration (`utils/step_graph`'s cache), the
port's counterpart of `jax.jit`'s one program per configuration (CPU).

On the card a new state of a configuration already captured replays the
cached graph from its first frame: its state is copied into the graph's
buffers, and the graph's own generator takes the state's generator's state
before each replay and hands it back after.  On the CPU a graph runs its
function eagerly through the same buffers and the same cache, so these
tests hold what the cache must not change: the JAX package's jitted scans
at two seeds against the port's through one cached graph; a cached run bit
for bit a run after `clear_graph_cache()`, generator included; two states
taking turns chunk by chunk, each its run alone; another shape another
graph; the least recently used graph evicted while a run that holds it goes
on; and `Mesh.close()` dropping the graphs keyed on its mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
from jetracer_orbslam2_tpu.config import MapConfig as JMapConfig
from jetracer_orbslam2_tpu.config import SystemConfig as JSystemConfig
from jetracer_orbslam2_tpu.config import TrackingConfig as JTrackingConfig
from jetracer_orbslam2_tpu.evaluation import ate as j_ate
from jetracer_orbslam2_tpu.io.synthetic import generate_sequence as j_generate_sequence
from jetracer_orbslam2_tpu.models import odometry as jodom
from jetracer_orbslam2_tpu.models import slam_scan as jss

from jetracer_orbslam2_torch.config import (
    FrontendConfig, MapConfig, SystemConfig, TrackingConfig)
from jetracer_orbslam2_torch.models import odometry as todom
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models import slam_scan as ss
from jetracer_orbslam2_torch.parallel import make_mesh
from jetracer_orbslam2_torch.utils import step_graph
from jetracer_orbslam2_torch.utils.step_graph import FrameGraph, StepGraph

from _torch_port_util import n

N, H, W = 21, 120, 160
_FE = dict(height=H, width=W, num_levels=2, max_keypoints=256)
_MAP = dict(max_keyframes=16, max_landmarks=2048, max_obs=8192, kf_min_gap=2,
            kf_max_gap=4, window_size=4)
CFG = SystemConfig(frontend=FrontendConfig(**_FE), map=MapConfig(**_MAP))
SEEDS = (0, 1)


@pytest.fixture(scope="module")
def arc():
    """21 frames of the forward arc (1 bootstrap + 20), as numpy arrays."""
    seq = j_generate_sequence(n_frames=N, shape=(H, W))
    return {"gray": np.round(np.asarray(seq.gray)).astype(np.float32),
            "depth": np.asarray(seq.depth), "intr": np.asarray(seq.intrinsics),
            "poses": np.asarray(seq.poses)}


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb.astype(np.float64)) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def _close_poses(a, b):
    """Every pose within 5 mm and 0.1 deg: the bars of
    test_torch_odometry.py::test_odometry_scan_matches_jax (the two packages
    draw their own RANSAC samples)."""
    for x, y in zip(a, b):
        assert np.linalg.norm(x[:3, 3] - y[:3, 3]) < 5e-3
        assert _rot_deg(x[:3, :3], y[:3, :3]) < 0.1


def _scan(s, seed, frames=None, chunk=None, cfg=CFG):
    """The port's slam_scan from a fresh state of `seed`: whole, or in
    chunks of `chunk` frames, each from the state the last left.
    -> (final, out, the handles of the chunks)."""
    frames = frames or (1, N)
    st = ss.init_scan_state(s["gray"][0], s["depth"][0], s["intr"], cfg,
                            seed=seed, device="cpu")
    lo, hi = frames
    chunk = chunk or hi - lo
    outs, handles = [], []
    for i in range(lo, hi, chunk):
        st, out = ss.slam_scan(st, s["gray"][i:i + chunk],
                               s["depth"][i:i + chunk], s["intr"], cfg)
        outs.append(out)
        handles.append(st.graph)
    out = ss.ScanOutput(*(torch.cat(f) for f in zip(*outs)))
    return st, out, handles


def _assert_runs_equal(a, b):
    """Outputs, every carried tensor (every map tensor too) and the
    generator's state afterwards `torch.equal`."""
    (fa, oa), (fb, ob) = a, b
    for f in ss.ScanOutput._fields:
        assert torch.equal(getattr(oa, f), getattr(ob, f)), f
    for f in ss._CARRIED:
        x, y = getattr(fa, f), getattr(fb, f)
        for i, (u, v) in enumerate(zip(*((x, y) if isinstance(x, tuple)
                                         else ((x,), (y,))))):
            assert torch.equal(u, v), f"{f}[{i}]"
    assert torch.equal(fa.generator.get_state(), fb.generator.get_state())


def test_slam_scan_matches_jax_at_two_seeds_through_one_cached_graph(arc):
    """(a) The jitted JAX scan, compiled once, from states of seeds 0 and 1,
    against the port's scan from states of seeds 0 and 1: the second run
    finds the first's graph in the cache.  Tracked flags and keyframes
    equal, poses within 5 mm and 0.1 deg, ATE < 5 cm
    (test_torch_slam_scan.py, test_torch_stereo.py)."""
    s = arc
    jc = JSystemConfig(frontend=JFrontendConfig(**_FE), map=JMapConfig(**_MAP))
    step_graph.clear_graph_cache("cpu")
    for seed in SEEDS:
        st = jss.init_scan_state(jnp.asarray(s["gray"][0]),
                                 jnp.asarray(s["depth"][0]),
                                 jnp.asarray(s["intr"]), jc, seed=seed)
        fj, oj = jss.slam_scan(st, jnp.asarray(s["gray"][1:]),
                               jnp.asarray(s["depth"][1:]),
                               jnp.asarray(s["intr"]), jc)
        pj = np.concatenate([np.asarray(fj.m.kf_pose[:1]),
                             np.asarray(jss.compose_trajectory(fj, oj))])
        ft, ot, (handle,) = _scan(s, seed)
        assert isinstance(handle, FrameGraph)
        assert handle.cache_hits == (seed != SEEDS[0])
        assert handle.eager_calls == N - 1 and handle.captures == 0
        pt = np.concatenate([n(ft.m.kf_pose[:1]), ss.compose_trajectory(ft, ot)])
        np.testing.assert_array_equal(n(ot.tracked), np.asarray(oj.tracked))
        assert n(ot.tracked).all()
        assert int(ft.m.num_kf) == int(fj.m.num_kf) >= 5
        _close_poses(pt, pj)
        assert float(j_ate(jnp.asarray(pt), jnp.asarray(s["poses"])).rmse) < 0.05
    assert step_graph.graph_cache_info()["held"]["cpu"] == 1


def test_odometry_scan_matches_jax_at_two_seeds_through_one_cached_graph(arc):
    """(a) The same for `odometry_scan`, at the bars of
    test_torch_odometry.py::test_odometry_scan_matches_jax."""
    s = arc
    fj, tj = JFrontendConfig(**_FE), JTrackingConfig()
    ft, tt = FrontendConfig(**_FE), TrackingConfig()
    step_graph.clear_graph_cache("cpu")
    for seed in SEEDS:
        st_j = jodom.init_state(jnp.asarray(s["gray"][0]),
                                jnp.asarray(s["depth"][0]),
                                jnp.asarray(s["intr"]), fj, tj, seed=seed)
        _, poses_j, ok_j = jodom.odometry_scan(
            st_j, jnp.asarray(s["gray"][1:]), jnp.asarray(s["depth"][1:]),
            jnp.asarray(s["intr"]), fj, tj)
        st_t = todom.init_state(s["gray"][0], s["depth"][0], s["intr"], ft, tt,
                                seed=seed, device="cpu")
        final, poses_t, ok_t = todom.odometry_scan(
            st_t, s["gray"][1:], s["depth"][1:], s["intr"], ft, tt)
        assert final.graph.cache_hits == (seed != SEEDS[0])
        assert final.graph.eager_calls == N - 1
        np.testing.assert_array_equal(n(ok_t), np.asarray(ok_j))
        assert n(ok_t).all()
        _close_poses(n(poses_t), np.asarray(poses_j))
        full = np.concatenate([np.eye(4, dtype=np.float32)[None], n(poses_t)])
        assert float(j_ate(jnp.asarray(full), jnp.asarray(s["poses"])).rmse) < 0.05


@pytest.mark.parametrize("seed", SEEDS)
def test_a_cached_run_is_a_run_on_a_fresh_graph(arc, seed):
    """(b) slam_scan, odometry_scan (three calls from one state, as
    `bench.py` times them) and `Slam` on a graph found in the cache,
    `torch.equal` to the same seed's run after `clear_graph_cache()`,
    generator state included."""
    s = arc
    _scan(s, 1 - seed, frames=(1, 6))          # the cache holds the graph
    cached = _scan(s, seed, frames=(1, 11))
    assert cached[2][0].cache_hits == 1
    assert step_graph.clear_graph_cache() >= 1
    fresh = _scan(s, seed, frames=(1, 11))
    assert fresh[2][0].cache_hits == 0
    _assert_runs_equal(cached[:2], fresh[:2])

    ft, tt = FrontendConfig(**_FE), TrackingConfig()
    st0 = todom.init_state(s["gray"][0], s["depth"][0], s["intr"], ft, tt,
                           seed=seed, device="cpu")
    g0 = st0.generator.get_state()
    step_graph.clear_graph_cache()
    calls = []
    for _ in range(3):
        st0.generator.set_state(g0)
        final, poses, ok = todom.odometry_scan(st0, s["gray"][1:8],
                                               s["depth"][1:8], s["intr"], ft, tt)
        calls.append((final, poses, ok, final.generator.get_state()))
    assert [c[0].graph.cache_hits for c in calls] == [0, 1, 1]
    for final, poses, ok, gen in calls[1:]:
        assert torch.equal(poses, calls[0][1]) and torch.equal(ok, calls[0][2])
        assert torch.equal(gen, calls[0][3])
        assert torch.equal(final.prev.desc, calls[0][0].prev.desc)

    def slam():
        sl = tslam.Slam(CFG, s["intr"], seed=seed, device="cpu")
        for i in range(8):
            sl.process_frame(s["gray"][i], s["depth"][i])
        return sl

    a = slam()
    b = slam()
    assert b._graphs["rgbd"].cache_hits == 1
    step_graph.clear_graph_cache()
    c = slam()
    assert c._graphs["rgbd"].cache_hits == 0
    for other in (b, c):
        np.testing.assert_array_equal(other.result().poses, a.result().poses)
        for x, y in zip(other.m, a.m):
            assert torch.equal(x, y)
        assert torch.equal(other.generator.get_state(), a.generator.get_state())


def test_two_states_take_turns_through_one_cached_graph(arc):
    """(c) States of seeds 0 and 1 take turns chunk by chunk through one
    cached graph: each is `torch.equal` to its run alone.  A switch copies
    the whole state into the buffers; a run that goes on from the state it
    left copies none."""
    s = arc
    alone = {seed: _scan(s, seed, chunk=5) for seed in SEEDS}
    for seed in SEEDS:
        handle = alone[seed][2][0]
        assert all(h is handle for h in alone[seed][2])
    states = {seed: ss.init_scan_state(s["gray"][0], s["depth"][0], s["intr"],
                                       CFG, seed=seed, device="cpu")
              for seed in SEEDS}
    outs = {seed: [] for seed in SEEDS}
    copied = {seed: [] for seed in SEEDS}
    for i in range(1, N, 5):
        for seed in SEEDS:
            st = states[seed]
            before = 0 if st.graph is None else st.graph.state_bytes_in
            st, out = ss.slam_scan(st, s["gray"][i:i + 5], s["depth"][i:i + 5],
                                   s["intr"], CFG)
            states[seed] = st
            outs[seed].append(out)
            copied[seed].append(st.graph.state_bytes_in - before)
    state_bytes = sum(x.numel() * x.element_size() for x in
                      states[0].graph._carry)
    for seed in SEEDS:
        out = ss.ScanOutput(*(torch.cat(f) for f in zip(*outs[seed])))
        _assert_runs_equal((states[seed], out), alone[seed][:2])
        assert copied[seed] == [state_bytes] * 4
        assert states[seed].graph._shared is states[1 - seed].graph._shared
    # alone, only the first chunk's state is copied in
    st = ss.init_scan_state(s["gray"][0], s["depth"][0], s["intr"], CFG,
                            device="cpu")
    st, _ = ss.slam_scan(st, s["gray"][1:3], s["depth"][1:3], s["intr"], CFG)
    first = st.graph.state_bytes_in
    st, _ = ss.slam_scan(st, s["gray"][3:5], s["depth"][3:5], s["intr"], CFG)
    assert first == state_bytes and st.graph.state_bytes_in == first


def test_another_shape_gets_its_own_graph():
    """(d) A keyed graph called with another shape gets the graph of that
    shape (as `jax.jit` compiles again), and the first shape's graph is
    found again; a graph of its own (no key) still raises."""
    step_graph.clear_graph_cache("cpu")

    def fn(gen, x):
        return x * 2 + torch.rand(x.shape, generator=gen)

    gen = torch.Generator().manual_seed(5)
    g = StepGraph(fn, gen, key=("double", "cpu"))
    a = g(torch.ones(4))
    b = g(torch.ones(5))
    c = g(torch.ones(4))
    assert (a.shape, b.shape, c.shape) == ((4,), (5,), (4,))
    assert g.cache_hits == 1 and g.eager_calls == 3
    assert step_graph.graph_cache_info()["held"]["cpu"] == 2
    ref = torch.Generator().manual_seed(5)
    want = [torch.ones(k) * 2 + torch.rand(k, generator=ref) for k in (4, 5, 4)]
    for got, w in zip((a, b, c), want):
        assert torch.equal(got, w)
    assert torch.equal(gen.get_state(), ref.get_state())

    def step(gen, carry, x):
        carry[0].add_(x)
        return carry[0] * 1

    f = FrameGraph(step, None, key=("acc", "cpu"))
    assert torch.equal(f((torch.zeros(3),), torch.ones(3)), torch.ones(3))
    assert torch.equal(f((torch.zeros(2),), torch.ones(2)), torch.ones(2))
    assert step_graph.graph_cache_info()["held"]["cpu"] == 4
    # the odometry scan at another frame shape: another graph
    ft = FrontendConfig(height=96, width=128, num_levels=2, max_keypoints=128)
    seq = j_generate_sequence(n_frames=4, shape=(96, 128))
    st = todom.init_state(np.asarray(seq.gray[0]), np.asarray(seq.depth[0]),
                          np.asarray(seq.intrinsics), ft, TrackingConfig(),
                          device="cpu")
    final, poses, _ = todom.odometry_scan(
        st, np.asarray(seq.gray[1:]), np.asarray(seq.depth[1:]),
        np.asarray(seq.intrinsics), ft, TrackingConfig())
    assert poses.shape == (3, 4, 4) and bool(torch.isfinite(poses).all())
    assert step_graph.graph_cache_info()["held"]["cpu"] == 5
    own = StepGraph(fn, gen)
    own(torch.ones(4))
    with pytest.raises(ValueError):
        own(torch.ones(5))


def test_the_bound_evicts_the_least_recently_used_graph(monkeypatch):
    """(e) Past CACHE_SIZE graphs on a device the least recently used leaves
    the cache; a run that holds it goes on through it, and a new run of its
    key captures (here: makes) a new graph."""
    monkeypatch.setattr(step_graph, "CACHE_SIZE", 2)
    step_graph.clear_graph_cache("cpu")

    def fn(gen, x):
        return x + 1

    handles = [StepGraph(fn, None, key=("inc", k)) for k in range(3)]
    for h in handles:
        h(torch.zeros(2))
    evicted = step_graph.graph_cache_info()["evicted"]
    assert step_graph.graph_cache_info()["held"]["cpu"] == 2
    held = handles[0]._shared
    assert torch.equal(handles[0](torch.ones(2)), torch.full((2,), 2.0))
    assert handles[0]._shared is held and handles[0].eager_calls == 2
    again = StepGraph(fn, None, key=("inc", 0))
    again(torch.zeros(2))
    assert again.cache_hits == 0 and again._shared is not held
    # that made room by evicting key 1, the least recently used
    info = step_graph.graph_cache_info()
    assert info["held"]["cpu"] == 2 and info["evicted"] == evicted + 1
    newest = StepGraph(fn, None, key=("inc", 2))
    newest(torch.zeros(2))
    assert newest.cache_hits == 1


def test_closing_a_mesh_drops_its_graphs(arc):
    """(f) `Mesh.close()` drops the graphs keyed on its mesh (a CPU gloo
    mesh of one rank): out of the cache, and a run that still holds one
    raises instead of running it; the meshless graph stays."""
    s = arc
    assert not dist.is_initialized()
    step_graph.clear_graph_cache("cpu")
    _scan(s, 0, frames=(1, 3))                 # the meshless graph
    mesh = make_mesh(device="cpu")
    try:
        st = ss.init_scan_state(s["gray"][0], s["depth"][0], s["intr"], CFG,
                                device="cpu")
        final, out = ss.slam_scan(st, s["gray"][1:4], s["depth"][1:4],
                                  s["intr"], CFG, mesh=mesh)
        assert mesh in final.graph.key and out.tracked.shape == (3,)
        assert step_graph.graph_cache_info()["held"]["cpu"] == 2
        dropped = step_graph.graph_cache_info()["dropped"]
    finally:
        mesh.close()
    assert not dist.is_initialized()
    info = step_graph.graph_cache_info()
    assert info["held"]["cpu"] == 1 and info["dropped"] == dropped + 1
    with pytest.raises(RuntimeError, match="mesh"):
        ss.slam_scan(final, s["gray"][4:5], s["depth"][4:5], s["intr"], CFG,
                     mesh=mesh)
    meshless = _scan(s, 0, frames=(1, 3))
    assert meshless[2][0].cache_hits == 1
