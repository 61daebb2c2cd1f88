"""The port's frame steps behind `utils/step_graph.StepGraph` (CPU), and the
rigid-fit route of `geometry.kabsch`.

On a CUDA device a `StepGraph` captures its step once and replays it each
frame; on the CPU it runs the step eagerly through the same static buffers.
These tests hold what the buffers must not change: `odometry_scan`,
`ChunkedOdometry`, `slam_scan` and `Slam` give what the eager step gives,
bit for bit, and within the JAX package's bars; the features carried to the
next frame are a copy, not the graph's buffer.  `geometry.kabsch` takes the
plain SVD route for CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
from jetracer_orbslam2_tpu.config import TrackingConfig as JTrackingConfig
from jetracer_orbslam2_tpu.io import synthetic as jsyn
from jetracer_orbslam2_tpu.models import odometry as jodom
from jetracer_orbslam2_tpu.ops import geometry as jgeo

from jetracer_orbslam2_torch.config import (
    FrontendConfig, MapConfig, SystemConfig, TrackingConfig)
from jetracer_orbslam2_torch.models import odometry as todom
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models import slam_scan as ss
from jetracer_orbslam2_torch.models.frontend import frontend_gray_depth
from jetracer_orbslam2_torch.ops import fused_rigid
from jetracer_orbslam2_torch.ops import geometry as tgeo
from jetracer_orbslam2_torch.utils import step_graph
from jetracer_orbslam2_torch.utils.step_graph import StepGraph

from _torch_port_util import FEATURE_FIELDS, n, t

close = np.testing.assert_allclose

N, H, W = 20, 120, 160
_CFG = dict(height=H, width=W, num_levels=2, max_keypoints=256)
SLAM_CFG = SystemConfig(
    frontend=FrontendConfig(**_CFG),
    map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                  kf_min_gap=2, kf_max_gap=4, window_size=4))


@pytest.fixture(scope="module")
def sequence():
    seq = jsyn.generate_sequence(n_frames=N, shape=(H, W))
    return {
        "gray": np.round(np.asarray(seq.gray)).astype(np.float32),
        "depth": np.asarray(seq.depth),
        "poses": np.asarray(seq.poses),
        "intr": np.asarray(seq.intrinsics),
    }


def _cfgs():
    return FrontendConfig(**_CFG), TrackingConfig()


def _start(s, seed=0):
    ft, tt = _cfgs()
    return todom.init_state(s["gray"][0], s["depth"][0], s["intr"], ft, tt,
                            seed=seed, device="cpu")


def _step_loop(s, frames, seed=0):
    """A loop of the eager `odometry_step`: (poses, flags)."""
    ft, tt = _cfgs()
    st = _start(s, seed)
    intr = t(s["intr"])
    poses, oks = [], []
    for i in range(1, frames):
        st, res = todom.odometry_step(st, t(s["gray"][i]), t(s["depth"][i]),
                                      intr, ft, tt)
        poses.append(res.T_wc)
        oks.append(res.tracked_ok)
    return torch.stack(poses), torch.stack(oks)


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_odometry_scan_replays_the_eager_step(sequence):
    s = sequence
    ft, tt = _cfgs()
    final, poses, ok = todom.odometry_scan(
        _start(s), s["gray"][1:], s["depth"][1:], s["intr"], ft, tt)
    ref_poses, ref_ok = _step_loop(s, N)
    assert torch.equal(poses, ref_poses) and torch.equal(ok, ref_ok)
    assert bool(ok.all()) and int(final.frame_idx) == N - 1
    g = final.graph
    assert isinstance(g, StepGraph)
    assert (g.eager_calls, g.captures, g.replays) == (N - 1, 0, 0)
    # the JAX scan on the same frames: the bars of
    # test_torch_odometry.py::test_odometry_scan_matches_jax
    fj, tj = JFrontendConfig(**_CFG), JTrackingConfig()
    st_j = jodom.init_state(jnp.asarray(s["gray"][0]), jnp.asarray(s["depth"][0]),
                            jnp.asarray(s["intr"]), fj, tj)
    _, poses_j, ok_j = jodom.odometry_scan(
        st_j, jnp.asarray(s["gray"][1:]), jnp.asarray(s["depth"][1:]),
        jnp.asarray(s["intr"]), fj, tj)
    np.testing.assert_array_equal(n(ok), n(ok_j))
    for a, b in zip(n(poses), n(poses_j)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 5e-3
        assert _rot_deg(a[:3, :3], b[:3, :3]) < 0.1


def test_chunked_odometry_equals_whole_scan_with_one_graph(sequence):
    s = sequence
    ft, tt = _cfgs()
    _, poses, ok = todom.odometry_scan(
        _start(s, seed=3), s["gray"][1:], s["depth"][1:], s["intr"], ft, tt)
    ch = todom.ChunkedOdometry(s["intr"], ft, tt, chunk_size=8, seed=3,
                               device="cpu")
    graphs = []
    for i in range(N):                  # 19 tracked frames: 8, 8, then 3
        ch.process_frame(s["gray"][i], s["depth"][i])
        if ch.state is not None and ch.state.graph is not None:
            graphs.append(ch.state.graph)
    ch.flush()
    poses_c, ok_c = ch.result()
    np.testing.assert_array_equal(poses_c[1:], n(poses))
    np.testing.assert_array_equal(ok_c[1:], n(ok))
    # the state carries one graph across the chunks
    assert len({id(g) for g in graphs + [ch.state.graph]}) == 1
    assert ch.state.graph.eager_calls == N - 1


def test_carried_features_are_a_copy(sequence):
    """After frame i+1 the carried `prev` holds frame i+1's features, and
    frame i's carried features are left as they were: each is a copy out of
    the graph's buffers, which the next frame overwrites."""
    s = sequence
    ft, tt = _cfgs()
    st1, _, _ = todom.odometry_scan(_start(s), s["gray"][1:2], s["depth"][1:2],
                                    s["intr"], ft, tt)
    first = {k: getattr(st1.prev, k).clone() for k in FEATURE_FIELDS}
    st2, _, _ = todom.odometry_scan(st1, s["gray"][2:3], s["depth"][2:3],
                                    s["intr"], ft, tt)
    assert st2.graph is st1.graph
    want = [frontend_gray_depth(t(s["gray"][i]), t(s["depth"][i]), t(s["intr"]),
                                ft, min_depth=tt.min_depth,
                                max_depth=tt.max_depth, device="cpu")
            for i in (1, 2)]
    buffers = {b.data_ptr() for b in st2.graph._static}
    for k in FEATURE_FIELDS:
        a, b = getattr(st1.prev, k), getattr(st2.prev, k)
        assert torch.equal(a, first[k]), k
        assert torch.equal(a, getattr(want[0], k)), k
        assert torch.equal(b, getattr(want[1], k)), k
        assert a.data_ptr() != b.data_ptr()
        assert a.data_ptr() not in buffers and b.data_ptr() not in buffers
    assert not torch.equal(st1.prev.xy, st2.prev.xy)


class _EagerStep:
    """`slam.tracking_step` called directly, with a tracking graph's call
    signature: the eager step the graph is held against."""

    def __init__(self, generator, cfg, extract=None):
        self.generator, self.cfg, self.extract = generator, cfg, extract

    def __call__(self, *args):
        return tslam.tracking_step(self.generator, *args, cfg=self.cfg,
                                   extract=self.extract)


class _EagerSlam(tslam.Slam):
    def _graph(self, name, extract=None):
        return _EagerStep(self.generator, self.cfg, extract)


@pytest.fixture(scope="module")
def arc():
    seq = jsyn.generate_sequence(n_frames=21, shape=(H, W))
    return (np.asarray(seq.gray), np.asarray(seq.depth),
            np.asarray(seq.intrinsics))


def _eager_scan(gray, depth, intr, cfg):
    """slam_scan's frames through `_step` with the eager tracking step."""
    st = ss.init_scan_state(gray[0], depth[0], intr, cfg, device="cpu")
    step = _EagerStep(st.generator, cfg, ss.frame_extract(cfg, st.T_wc.device))
    rows = []
    for i in range(1, gray.shape[0]):
        st, row = ss._step(st, t(gray[i]), t(depth[i]), (None, False),
                           t(intr), cfg, None, step)
        rows.append(row)
    ref_uid, T_rel, T_w_emit, tracked, is_kf = zip(*rows)
    return st, ss.ScanOutput(
        ref_uid=torch.stack(ref_uid), T_rel=torch.stack(T_rel),
        T_w_emit=torch.stack(T_w_emit), tracked=torch.stack(tracked),
        is_kf=torch.tensor(is_kf))


def test_slam_scan_and_slam_replay_the_eager_tracking_step(arc):
    gray, depth, intr = arc
    cfg = SLAM_CFG
    st = ss.init_scan_state(gray[0], depth[0], intr, cfg, device="cpu")
    final, out = ss.slam_scan(st, gray[1:], depth[1:], intr, cfg)
    e_final, e_out = _eager_scan(gray, depth, intr, cfg)
    for name in ss.ScanOutput._fields:
        assert torch.equal(getattr(out, name), getattr(e_out, name)), name
    assert (int(final.m.num_kf), int(final.num_loops), int(final.num_relocs)) \
        == (int(e_final.m.num_kf), int(e_final.num_loops),
            int(e_final.num_relocs))
    assert int(final.m.num_kf) >= 5
    assert final.graph.eager_calls == gray.shape[0] - 1

    runs = {}
    for name, cls, by_features in (("graph", tslam.Slam, False),
                                   ("features", tslam.Slam, True),
                                   ("eager", _EagerSlam, False)):
        slam = cls(cfg, intr, device="cpu")
        for i in range(gray.shape[0]):
            if by_features:
                slam.process_features(slam.features(gray[i], depth[i]))
            else:
                slam.process_frame(gray[i], depth[i])
        runs[name] = slam.result()
    for name in ("features", "eager"):
        np.testing.assert_array_equal(runs[name].poses, runs["graph"].poses)
        np.testing.assert_array_equal(runs[name].tracked, runs["graph"].tracked)
        assert runs[name].num_keyframes == runs["graph"].num_keyframes
        assert runs[name].num_loops == runs["graph"].num_loops
    # the scan and the host loop seeded alike: the bars of
    # test_torch_slam_scan.py::test_slam_scan_matches_the_host_loop
    o = runs["graph"]
    assert (int(final.m.num_kf), int(final.num_loops)) == (
        o.num_keyframes, o.num_loops)
    np.testing.assert_array_equal(n(out.tracked), o.tracked[1:])
    poses = np.concatenate([n(final.m.kf_pose[:1]),
                            ss.compose_trajectory(final, out)])
    close(poses, o.poses, rtol=0, atol=1e-3)


def test_relocalization_between_steps_draws_as_the_eager_step(arc):
    """Frames 12-15 blank: tracking fails, relocalization draws from the
    run's generator between tracking steps and re-poses frame 16; the
    scan and the host loop give what their eager steps give."""
    gray, depth, intr = arc
    gray = gray.copy()
    gray[12:16] = 0
    st = ss.init_scan_state(gray[0], depth[0], intr, SLAM_CFG, device="cpu")
    final, out = ss.slam_scan(st, gray[1:], depth[1:], intr, SLAM_CFG)
    e_final, e_out = _eager_scan(gray, depth, intr, SLAM_CFG)
    for name in ss.ScanOutput._fields:
        assert torch.equal(getattr(out, name), getattr(e_out, name)), name
    assert int(final.num_relocs) == int(e_final.num_relocs) >= 1
    assert not bool(out.tracked[11:15].any()) and bool(out.tracked[16:].all())
    runs = []
    for cls in (tslam.Slam, _EagerSlam):
        slam = cls(SLAM_CFG, intr, device="cpu")
        for i in range(gray.shape[0]):
            slam.process_frame(gray[i], depth[i])
        runs.append(slam.result())
    graphed, eager = runs
    np.testing.assert_array_equal(graphed.poses, eager.poses)
    np.testing.assert_array_equal(graphed.tracked, eager.tracked)
    assert graphed.num_relocs == eager.num_relocs >= 1
    assert graphed.num_keyframes == eager.num_keyframes


def test_imu_flag_on_the_device_selects_the_same_prior(arc):
    """`track_and_associate` with imu_ok as a () bool tensor (the captured
    step's form) gives what the host bool gives, bit for bit."""
    gray, depth, intr = arc
    slam = tslam.Slam(SLAM_CFG, intr, device="cpu")
    slam.process_frame(gray[0], depth[0])
    feats = slam.features(gray[1], depth[1])
    dw = np.float32([0.01, -0.02, 0.005])
    for ok in (False, True):
        outs = []
        for flag in (ok, torch.tensor(ok)):
            g = torch.Generator().manual_seed(4)
            outs.append(tslam.track_and_associate(
                slam.prev, feats, slam.m, slam.T_wc, slam.velocity, dw, flag,
                torch.tensor(1, dtype=torch.int32), slam.intr, g, SLAM_CFG,
                device="cpu"))
        (res_a, idx_a, ok_a, rep_a), (res_b, idx_b, ok_b, rep_b) = outs
        assert torch.equal(res_a.velocity, res_b.velocity)
        assert torch.equal(rep_a.packed, rep_b.packed)
        assert torch.equal(idx_a, idx_b) and torch.equal(ok_a, ok_b)


def test_kabsch_on_cpu_takes_the_plain_route(monkeypatch):
    calls = []
    plain = fused_rigid.rigid_fit_reference

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(fused_rigid, "rigid_fit_reference", counted)
    # test_torch_geometry.py::test_kabsch_matches's problem and bars
    rng = np.random.default_rng(5)
    xi = np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 0.4, 3)]).astype(np.float32)
    T = n(jgeo.se3_exp(jnp.asarray(xi)))
    src = rng.normal(0, 1.5, (120, 3)).astype(np.float32)
    dst = (src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(0, 0.01, (120, 3))).astype(np.float32)
    w = (rng.random(120) > 0.3).astype(np.float32)
    got = n(tgeo.kabsch(t(src), t(dst), t(w)))
    ref = n(jgeo.kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    assert len(calls) == 1
    close(got, ref, rtol=0, atol=1e-5)
    close(got, T, rtol=0, atol=2e-2)
    # all weights 0: H = 0, and the SVD route gives the identity
    zero = n(tgeo.kabsch(t(src), t(dst), torch.zeros(120)))
    close(zero, np.eye(4), rtol=0, atol=0)


def test_rigid_fit_checks_its_inputs():
    src = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError):
        fused_rigid.rigid_fit(src, torch.zeros(2, 4, 3))
    with pytest.raises(ValueError):
        fused_rigid.rigid_fit(src, src, torch.ones(2, 4))
    with pytest.raises(ValueError):
        fused_rigid.rigid_fit(torch.zeros(5, 2), torch.zeros(5, 2))
    out = fused_rigid.rigid_fit(src.double(), src.double())
    assert out.shape == (2, 4, 4) and out.dtype == torch.float64


def test_step_graph_buffers():
    """Inputs copied only when they changed, outputs copied out of the
    buffers, the structure fixed by the first call."""
    seen = []

    def fn(gen, a, pair):
        seen.append((a.clone(), pair[0].clone()))
        return None, (a + pair[0], a * 2)

    g = StepGraph(fn, None)
    a, b = torch.ones(3), torch.zeros(3)
    none, (s1, d1) = g(a, (b, None))
    assert none is None and torch.equal(s1, torch.ones(3))
    buf_a, buf_b = g._static
    assert buf_a.data_ptr() != a.data_ptr()          # a buffer, not the input
    b2 = torch.full((3,), 5.0)
    _, (s2, _) = g(a, (b2, None))
    assert torch.equal(s2, torch.full((3,), 6.0))
    assert torch.equal(s1, torch.ones(3))            # an earlier output stays
    assert g._static[0] is buf_a and g._copied[0][0] is a
    a.add_(1.0)                                      # in place: copied again
    _, (s3, d3) = g(a, (b2, None))
    assert torch.equal(s3, torch.full((3,), 7.0)) and torch.equal(d3, 2 * a)
    assert torch.equal(d1, torch.full((3,), 2.0))
    assert g.eager_calls == 3 and (g.captures, g.replays) == (0, 0)
    with pytest.raises(ValueError):
        g(a, (b2,))                                  # another structure
    with pytest.raises(ValueError):
        g(torch.ones(4), (b2, None))                 # another shape


def test_note_launch_counts_launches_and_capture_nodes(monkeypatch):
    def wrapper():
        pass

    wrapper.launches = 0
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    step_graph.note_launch(wrapper)
    assert wrapper.launches == 1
    capturing[0] = True
    step_graph.note_launch(wrapper)            # a capture not of a StepGraph
    assert wrapper.launches == 1
    monkeypatch.setattr(step_graph, "_recording", {})
    step_graph.note_launch(wrapper)
    step_graph.note_launch(wrapper)
    assert step_graph._recording == {wrapper: 2} and wrapper.launches == 1
