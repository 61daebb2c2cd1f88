"""K8's launch shape, the packed LM collective and the route of `slam_scan`
for a mesh that K8 cannot serve (CPU).

K8 (`ops/fused_allreduce.py`, `csrc/peer_allreduce.cu`) runs only on the
card, where `chip_smoke.py` phase 25 (d) holds it `torch.equal` to the
rank-order sum at every launch shape the wrapper picks; here the wrapper's
pure functions (the grid, the receive area, the bound) are checked.  An LM
iteration of the landmark-sharded BA sums its four pose-sized partials in
one collective (`Mesh.psum_many`) and its cost in another, on both routes,
and the one-rank mesh stays `bundle_adjust` bit for bit.  A mesh on the
card without K8's buffers (more than 8 ranks, several hosts) runs
`slam_scan`, `ChunkedSlam` and the CLI's `--chunked C --mesh N` through the
host-branch step `_step` with the group's collectives, and says so; a mesh
with them runs the frame graph.  The route follows the record the mesh made
at set-up (`Mesh.k8_unservable`), and a closed mesh takes none.  "On the
card" is stood for by a mesh whose `capturable` is the card's rule (`peers
is not None`), over a one-rank gloo group on the CPU, with that record set
as `Mesh.__init__` sets it where `map_peers` gives None.
"""

import json

import pytest
import torch
import torch.distributed as dist

from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.config import (
    BAConfig, FrontendConfig, MapConfig, SystemConfig)
from jetracer_orbslam2_torch.io.synthetic import generate_sequence
from jetracer_orbslam2_torch.models import slam_scan as ss
from jetracer_orbslam2_torch.models.backend.ba import bundle_adjust
from jetracer_orbslam2_torch.ops import fused_allreduce as far
from jetracer_orbslam2_torch.parallel import (
    make_mesh, prepare_sharded_problem, sharded_bundle_adjust)
from jetracer_orbslam2_torch.parallel.bench_ba import make_synthetic_ba
from jetracer_orbslam2_torch.parallel.mesh import Mesh

# small tensors only: see tests/_torch_port_util.py
torch.set_num_threads(1)

H, W = 120, 160
CFG = SystemConfig(
    frontend=FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=256),
    map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                  kf_min_gap=2, kf_max_gap=4, window_size=4))
FRAMES = 9


@pytest.fixture
def mesh():
    """A one-rank gloo group on the CPU, destroyed at teardown."""
    assert not dist.is_initialized()
    m = make_mesh(device="cpu")
    yield m
    m.peers = None
    m.close()
    assert not dist.is_initialized()


@pytest.fixture
def on_the_card(monkeypatch):
    """A mesh's `capturable` as on the card: only with K8's buffers."""
    monkeypatch.setattr(Mesh, "capturable",
                        property(lambda self: self.peers is not None))


# ---------------------------------------------------------------------------
# (c) the wrapper's launch shape, receive area and bound
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,world,blocks", [
    (1, 1, 1), (49152, 1, 1), (1, 4, 1), (48, 4, 1), (2304, 4, 1),
    (2688, 4, 1), (4096, 4, 1), (4097, 4, 2), (4704, 4, 2), (49152, 4, 12),
    (65536, 4, 16), (2 * 65536 + 7, 3, 16), (0, 2, 1)])
def test_launch_blocks(n, world, blocks):
    """One block up to FLOATS_PER_BLOCK floats a chunk, one more a
    FLOATS_PER_BLOCK past it, at most MAX_BLOCKS (a full chunk); one rank
    one block, whatever the payload."""
    assert far.launch_blocks(n, world) == blocks
    assert 1 <= blocks <= far.MAX_BLOCKS


def test_every_chunk_fits_the_grid():
    """A chunk is at most a slot of the receive area, and the grid's blocks
    cover it in slices of a multiple of 4 floats, as the kernel cuts them."""
    assert far.STAGING_FLOATS == far.MAX_BLOCKS * far.FLOATS_PER_BLOCK
    for n in (1, 7, 4097, 49152, 65536, 2 * 65536 + 7):
        blocks = far.launch_blocks(n, 4)
        chunk = min(n, far.STAGING_FLOATS)
        per = -(-(-(-chunk // blocks)) // 4) * 4
        assert per * blocks >= chunk and per * (blocks - 1) < chunk


def test_receive_area_and_bound():
    """Two copies of `world` slots a rank; the bound is what any all-reduce
    must move, not what the one-shot push sends: the larger of the call's
    own HBM bytes and the 2 (world - 1) / world of the payload a rank
    receives over NVLink at least; one rank in place moves nothing."""
    assert far.area_bytes(1) == 2 * far.STAGING_FLOATS * 4
    assert far.area_bytes(8) == 8 * far.area_bytes(1)
    assert far.bound_seconds(2304, 4) == pytest.approx(
        2 * 3 / 4 * 2304 * 4 / 450e9)
    assert far.bound_seconds(49152, 4) * 1e6 == pytest.approx(0.65536)
    assert far.bound_seconds(49152, 4) < 3 * 49152 * 4 / 450e9
    assert far.bound_seconds(4704, 3) == pytest.approx(
        2 * 2 / 3 * 4704 * 4 / 450e9)
    assert far.bound_seconds(1, 2) == pytest.approx(4 / 450e9)  # NVLink's
    assert far.bound_seconds(2304, 1) == 0.0


# ---------------------------------------------------------------------------
# (b) an LM iteration's collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_an_lm_iteration_makes_one_packed_collective(mesh, fused,
                                                     monkeypatch):
    """At P 8 an LM iteration all-reduces Hpp (8, 6, 6), Gh G^T (48, 48),
    bp and Gh bl (8, 6) as one buffer of 2,688 floats, then its cost: with
    the initial cost and the gather, 2 x iterations + 2 collectives, the
    one-rank mesh `torch.equal` to `bundle_adjust`."""
    sizes = []
    real = Mesh._all_reduce

    def record(self, x):
        sizes.append(x.numel())
        real(self, x)

    monkeypatch.setattr(Mesh, "_all_reduce", record)
    prob, intr = make_synthetic_ba(8, 64, 4, device="cpu")
    cfg = BAConfig(iters=3)
    p1, x1, stats = bundle_adjust(prob, intr, cfg, fused=fused, device="cpu")
    assert sizes == []                  # unsharded: no collective
    sprob = prepare_sharded_problem(prob, 1, device="cpu")
    p2, x2, trace = sharded_bundle_adjust(sprob, intr, cfg, mesh, fused=fused)
    assert sizes == [1] + [8 * 36 + 48 * 48 + 48 + 48, 1] * 3 + [64 * 3]
    assert torch.equal(p1, p2) and torch.equal(x1, x2)
    assert torch.equal(stats.cost, trace)


def test_psum_many_is_a_psum_each(mesh):
    """One buffer, one collective, views in the partials' shapes: on one rank
    each the partial itself, as `psum` gives it."""
    g = torch.Generator().manual_seed(3)
    xs = (torch.randn(8, 6, 6, generator=g), torch.randn(48, 48, generator=g),
          torch.randn(8, 6, generator=g), torch.randn((), generator=g))
    got = mesh.psum_many(*xs)
    assert len(got) == len(xs)
    for y, x in zip(got, xs):
        assert y.shape == x.shape and torch.equal(y, mesh.psum(x))


# ---------------------------------------------------------------------------
# (a) the route of a mesh that K8 cannot serve
# ---------------------------------------------------------------------------

def test_capturable_follows_the_mesh_as_set_up(mesh, monkeypatch):
    """On the card a mesh is capturable only with K8's buffers; a CPU mesh
    always (its frame graph runs host `if`s).  The route follows the
    set-up's record of why K8 does not serve the mesh; without buffers and
    without a record the mesh was closed, and takes no route."""
    assert mesh.capturable and ss.scan_route(mesh) == "frame_graph"
    assert mesh.k8_unservable is None and not mesh.closed
    assert ss.scan_route(None) == "frame_graph"
    monkeypatch.setattr(mesh, "device", torch.device("cuda", 0))
    assert mesh.closed and not mesh.capturable
    for check in (ss.scan_route, Mesh.check_capturable):
        with pytest.raises(RuntimeError, match="closed"):
            check(mesh)
    mesh.k8_unservable = "more than 8 ranks"
    assert not mesh.closed and not mesh.capturable
    assert ss.scan_route(mesh) == "host_branch"
    assert "more than 8 ranks" in repr(mesh)
    ref = mesh.reference()
    assert not ref.capturable and "Mesh.reference" in ref.k8_unservable
    mesh.k8_unservable, mesh.peers = None, object()
    assert mesh.capturable and ss.scan_route(mesh) == "frame_graph"
    assert "K8" in repr(mesh)
    assert ss.scan_route(mesh.reference()) == "host_branch"


class _Buffers:
    """K8's buffers as `map_peers` returns them, closing nothing."""

    def close(self):
        pass


@pytest.mark.parametrize("case,world,mapped,why", [
    ("k8", 4, True, None),
    ("several_hosts", 4, False, "ranks on several hosts"),
    ("nine_ranks", 9, False, "more than 8 ranks")])
def test_the_route_is_recorded_at_set_up(mesh, monkeypatch, case, world,
                                         mapped, why):
    """A mesh on the card records at set-up why `map_peers` gave no
    buffers, and its route follows that record: the K8 mesh runs the frame
    graph, the others the host-branch step.  Closing the K8 mesh does not
    turn it into one of those: it raises where a route is asked for."""
    from jetracer_orbslam2_torch.parallel import mesh as mesh_mod

    asked = []

    def map_peers(rank, size, device):
        asked.append((rank, size, device))
        return _Buffers() if mapped else None

    monkeypatch.setattr(mesh_mod.fused_allreduce, "map_peers", map_peers)
    monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda: world)
    card = Mesh(torch.device("cuda", 0))
    assert asked == [(0, world, torch.device("cuda", 0))]
    assert card.k8_unservable == why and card.capturable is mapped
    assert ss.scan_route(card) == ("frame_graph" if mapped else "host_branch")
    card.close()
    if mapped:
        assert card.closed and card.k8_unservable is None
        with pytest.raises(RuntimeError, match="closed"):
            ss.scan_route(card)
    else:
        assert ss.scan_route(card) == "host_branch"


def _frames():
    seq = generate_sequence(n_frames=FRAMES, shape=(H, W), device="cpu")
    return seq.gray, seq.depth, seq.intrinsics


def _reference(gray, depth, intr, mesh):
    """`_step(plain_collectives=True)` frame by frame."""
    state = ss.init_scan_state(gray[0], depth[0], intr, CFG, device="cpu")
    rows = []
    for i in range(1, gray.shape[0]):
        state, row = ss._step(state, gray[i], depth[i], (None, False), intr,
                              CFG, mesh, plain_collectives=True)
        rows.append(row[:4] + (torch.tensor(row[4]),))
    return state, ss.ScanOutput(*(torch.stack(f) for f in zip(*rows)))


def _assert_states_equal(a, b):
    for f in ss._CARRIED:
        x, y = getattr(a, f), getattr(b, f)
        if f in ("m", "prev"):
            for g, u, v in zip(x._fields, x, y):
                assert torch.equal(u, v), f"{f}.{g}"
        else:
            assert torch.equal(x, y), f


def test_a_mesh_k8_cannot_serve_runs_the_host_branch_step(
        mesh, on_the_card, monkeypatch):
    """`slam_scan` and `ChunkedSlam` with such a mesh run every frame through
    `_step` with the group's collectives, never a frame graph, name the
    route, and give `_step(plain_collectives=True)`'s outputs, counters and
    map bit for bit."""
    gray, depth, intr = _frames()
    want_state, want = _reference(gray, depth, intr, mesh)
    assert int(want.is_kf.sum()) >= 1       # the sharded BA ran

    steps = []
    real_step = ss._step

    def step(*a, **k):
        steps.append(a[6] if len(a) > 6 else k.get("mesh"))
        return real_step(*a, **k)

    def no_graph(*a, **k):
        raise AssertionError("a frame graph for a mesh K8 cannot serve")

    monkeypatch.setattr(ss, "_step", step)
    monkeypatch.setattr(ss, "frame_graph", no_graph)
    assert mesh.peers is None and not mesh.capturable
    mesh.k8_unservable = "more than 8 ranks"      # as set-up records it
    state = ss.init_scan_state(gray[0], depth[0], intr, CFG, device="cpu")
    final, out = ss.slam_scan(state, gray[1:], depth[1:], intr, CFG, mesh=mesh)
    assert final.route == "host_branch"
    assert steps == [mesh] * (FRAMES - 1)
    for f in ss.ScanOutput._fields:
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    _assert_states_equal(final, want_state)

    ch = ss.ChunkedSlam(CFG, intr, chunk_size=3, mesh=mesh, device="cpu")
    assert ch.route == "host_branch"
    for i in range(FRAMES):
        ch.process_frame(gray[i], depth[i])
    ch.flush()
    assert ch.state.route == "host_branch" and len(ch._outs) == 3
    assert (ch.tracked()[1:] == want.tracked.numpy()).all()
    _assert_states_equal(ch.state, want_state)


def test_a_mesh_k8_serves_runs_the_frame_graph(mesh, on_the_card,
                                               monkeypatch):
    """With K8's buffers the same scan asks for the frame graph and never
    runs `_step`."""
    gray, depth, intr = _frames()
    asked = []

    def graph(state, cfg, m=None):
        asked.append(m)
        raise StopIteration

    def no_step(*a, **k):
        raise AssertionError("host branches for a mesh K8 serves")

    monkeypatch.setattr(ss, "frame_graph", graph)
    monkeypatch.setattr(ss, "_step", no_step)
    mesh.peers = object()
    state = ss.init_scan_state(gray[0], depth[0], intr, CFG, device="cpu")
    with pytest.raises(StopIteration):
        ss.slam_scan(state, gray[1:3], depth[1:3], intr, CFG, mesh=mesh)
    assert asked == [mesh]
    assert ss.ChunkedSlam(CFG, intr, mesh=mesh, device="cpu").route == (
        "frame_graph")


def test_the_cli_reports_the_route(on_the_card, capsys, monkeypatch):
    """`--chunked C --mesh 1` with a mesh whose buffers K8 cannot map runs
    and reports `host_branch` (map_peers gives None for such a group, and
    the mesh records why at set-up)."""
    real_init = Mesh.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        self.k8_unservable = "more than 8 ranks"

    monkeypatch.setattr(Mesh, "__init__", init)
    argv = ["--synthetic", "4", "--json", "--device", "cpu", "--levels", "2",
            "--max-keypoints", "256", "--mesh", "1"]
    assert trun.main(argv + ["--chunked", "3"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not dist.is_initialized()
    assert report["scan_route"] == "host_branch"
    assert report["mesh_devices"] == 1 and report["frames"] == 4
    assert report["tracked_frac"] == 1.0 and report["keyframes"] >= 1

