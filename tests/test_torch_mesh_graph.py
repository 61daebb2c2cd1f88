"""The mesh run of `slam_scan` through the frame graph (CPU).

`slam_scan(mesh=...)` replays the frame graph whose keyframe body holds the
landmark-sharded windowed BA (`parallel/ba_sharded.sharded_local_ba`) and its
collectives, as the JAX package's jitted scan holds its `shard_map`'d BA
inside the keyframe `lax.cond`.  On a CUDA device the body is a conditional
node of the captured graph (held against the host-branch step on the card
by `chip_smoke.py` phase 25 (d)); on the CPU the same function runs each
branch as a host `if`, over a one-rank gloo group.  These tests hold what
the CPU can show: the mesh scan runs the graph's function and is, bit for
bit, the host-branch step with the same mesh and the meshless scan; its
dropped-edge count is a () int32 device counter; a frame graph is reused
only with the mesh it was made for; the sharded BA reads nothing back; every
collective of a mesh on the card is K8 (`ops/fused_allreduce.py`) on the
buffers the ranks map at set-up where K8 can serve the group, a frame graph
raises without them, and the plain version, the group's all-reduce, is what
a CPU tensor takes and what the host-branch step asks for by name.
"""

import inspect
import re

import pytest
import torch
import torch.distributed as dist

from jetracer_orbslam2_torch.config import FrontendConfig, MapConfig, SystemConfig
from jetracer_orbslam2_torch.io.synthetic import generate_sequence
from jetracer_orbslam2_torch.models import slam_scan as ss
from jetracer_orbslam2_torch.models.backend import map as tmap
from jetracer_orbslam2_torch.ops import fused_allreduce
from jetracer_orbslam2_torch.parallel import ba_sharded, make_mesh
from jetracer_orbslam2_torch.parallel.mesh import Mesh
from jetracer_orbslam2_torch.utils.step_graph import FrameGraph

# small tensors only: see tests/_torch_port_util.py
torch.set_num_threads(1)

H, W = 120, 160
CFG = SystemConfig(
    frontend=FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=256),
    map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                  kf_min_gap=2, kf_max_gap=4, window_size=4))


def _host_branch_scan(state, gray, depth, intr, mesh):
    """`_step` frame by frame: the branches on host values."""
    rows = []
    for i in range(gray.shape[0]):
        state, row = ss._step(state, gray[i], depth[i], (None, False), intr,
                              CFG, mesh)
        rows.append(row[:4] + (torch.tensor(row[4]),))
    return state, ss.ScanOutput(*(torch.stack(f) for f in zip(*rows)))


@pytest.fixture(scope="module")
def runs():
    """Sixteen frames of the arc at 120x160, frames 8-11 blank (the tracker
    loses them and relocalizes; keyframes before and after), through the
    mesh scan, the host-branch step with the same mesh and the meshless
    scan.  The one-rank gloo group is destroyed before the tests run."""
    seq = generate_sequence(n_frames=16, shape=(H, W), device="cpu")
    gray, depth, intr = seq.gray.clone(), seq.depth, seq.intrinsics
    gray[8:12] = 0
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        out = {}
        for name in ("graph", "step", "meshless"):
            st = ss.init_scan_state(gray[0], depth[0], intr, CFG, device="cpu")
            if name == "graph":
                real_step, ss._step = ss._step, None   # the graph's function
                try:
                    out[name] = ss.slam_scan(st, gray[1:], depth[1:], intr, CFG,
                                             mesh=mesh)
                finally:
                    ss._step = real_step
            elif name == "step":
                out[name] = _host_branch_scan(st, gray[1:], depth[1:], intr,
                                              mesh)
            else:
                out[name] = ss.slam_scan(st, gray[1:], depth[1:], intr, CFG)
        out["mesh"] = mesh
    finally:
        mesh.close()
    assert not dist.is_initialized()
    return out


def _assert_runs_equal(a, b):
    (fa, oa), (fb, ob) = a, b
    for f in ss.ScanOutput._fields:
        assert torch.equal(getattr(oa, f), getattr(ob, f)), f
    for f in ss._CARRIED:
        if f == "m":
            continue
        if f == "prev":
            for g, x, y in zip(fa.prev._fields, fa.prev, fb.prev):
                assert torch.equal(x, y), f"prev.{g}"
            continue
        assert torch.equal(getattr(fa, f), getattr(fb, f)), f
    for f, x, y in zip(tmap.MapState._fields, fa.m, fb.m):
        assert torch.equal(x, y), f"m.{f}"


def test_mesh_scan_runs_the_frame_graph(runs):
    final, out = runs["graph"]
    graph = final.graph
    assert isinstance(graph, FrameGraph)
    assert graph.eager_calls == out.tracked.shape[0] == 15
    assert runs["mesh"] in graph.key
    # the sequence takes both branches
    assert int(out.is_kf.sum()) >= 2 and int(final.num_relocs) >= 1


@pytest.mark.parametrize("other", ["step", "meshless"])
def test_mesh_scan_is_the_host_branch_step_and_the_meshless_scan(runs, other):
    """Outputs, every carried counter (`ba_edges_dropped` too) and every map
    tensor `torch.equal`: on one rank the sharded BA is `local_ba`."""
    _assert_runs_equal(runs["graph"], runs[other])


def test_dropped_edges_are_a_device_counter(runs):
    for name in ("graph", "step", "meshless"):
        dropped = runs[name][0].ba_edges_dropped
        assert isinstance(dropped, torch.Tensor), name
        assert dropped.shape == () and dropped.dtype == torch.int32, name
    assert int(runs["graph"][0].ba_edges_dropped) == int(
        runs["step"][0].ba_edges_dropped) == 0


def test_dropped_edges_add_up_in_the_keyframe_body(runs, monkeypatch):
    """The keyframe body adds the sharded BA's count to the carried counter
    in place, as the graph's buffers need, and only with a mesh."""
    final = runs["graph"][0]
    carried = {f: getattr(final, f) for f in ss._CARRIED}
    calls = []

    def fake_update(*a, mesh=None, **k):
        calls.append(mesh)
        m = final.m
        return ss.slam_mod.KeyframeUpdate(
            m=m, T_wc=final.T_wc, slot=m.num_kf - 1, looped=0, compacted=0,
            loop_prev_uid=final.loop_prev_uid, loop_consist=final.loop_consist,
            ba_dropped=torch.tensor(3, dtype=torch.int32))

    monkeypatch.setattr(ss.slam_mod, "keyframe_update", fake_update)

    class Step:
        """A tracked frame that asks for a keyframe."""

        feats = final.prev
        velocity = final.velocity
        since_kf = final.frames_since_kf
        lost_streak = final.lost_streak
        lm_idx = lm_ok = u_loop = u_reloc = None
        flags = (None, torch.tensor(True), torch.tensor(False))

        class report:
            T_wc = final.T_wc
            tracked_ok = torch.tensor(True)
            need_kf = torch.tensor(True)

    for mesh, want in ((runs["mesh"], 3), (None, 0)):
        state = {f: (v.clone() if isinstance(v, torch.Tensor) else v)
                 for f, v in carried.items()}
        buf = state["ba_edges_dropped"]
        S = ss.Carry(state, in_place=True)
        ss._frame(S, lambda *a: Step, (None, None), (None, None), None, CFG,
                  mesh)
        assert S.ba_edges_dropped is buf and int(buf) == want
    assert calls == [runs["mesh"], None]


def test_a_frame_graph_is_reused_only_with_its_mesh(runs):
    final, _ = runs["meshless"]
    meshless = final.graph
    assert ss.frame_graph(final, CFG) is meshless
    with_mesh = ss.frame_graph(final, CFG, runs["mesh"])
    assert with_mesh is not meshless
    mesh_final = runs["graph"][0]
    assert ss.frame_graph(mesh_final, CFG, runs["mesh"]) is mesh_final.graph
    assert ss.frame_graph(mesh_final, CFG) is not mesh_final.graph


def _no_host_read(fn) -> list:
    src = inspect.getsource(fn)
    src = "\n".join(line.split("#")[0] for line in src.splitlines())
    return re.findall(r"\.cpu\(|\.tolist\(|\.item\(|\bbool\(", src)


@pytest.mark.parametrize("fn", [ba_sharded.sharded_local_ba,
                                ba_sharded._sharded_lm_run, Mesh.psum,
                                Mesh.psum_many, Mesh.gather_blocks,
                                Mesh._all_reduce,
                                fused_allreduce.peer_allreduce],
                         ids=lambda f: f.__name__)
def test_the_sharded_ba_reads_nothing_back(fn):
    assert _no_host_read(fn) == []


def test_every_collective_of_a_mesh_on_the_card_goes_through_k8(monkeypatch):
    """A mesh with the ranks' buffers mapped takes K8 for every collective,
    whether a CUDA graph is capturing or not (one kernel for every path, so
    every path sums in the same order); its reference view and a mesh
    without them take the plain version, the group's all-reduce."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert mesh.peers is None             # a CPU mesh: no peer buffers
    calls = []
    monkeypatch.setattr(fused_allreduce, "peer_allreduce",
                        lambda x, peers: calls.append(("K8", peers)))
    monkeypatch.setattr(fused_allreduce, "peer_allreduce_reference",
                        lambda x: calls.append(("plain", None)))
    try:
        x = torch.arange(6, dtype=torch.float32)
        mesh.psum(x)
        mesh.peers = peers = object()
        for capturing in (True, False):
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                                lambda: capturing)
            mesh.psum(x)
            mesh.gather_blocks(x)
        ref = mesh.reference()
        assert ref.peers is None and not ref.owns_group
        assert ref.size == mesh.size and ref.rank == mesh.rank
        ref.psum(x)
        ref.gather_blocks(x)
        ref.close()                       # a view: closes nothing
        assert mesh.peers is peers and dist.is_initialized()
        assert calls == [("plain", None)] + [("K8", peers)] * 4 + [
            ("plain", None)] * 2
    finally:
        mesh.peers = None
        mesh.close()


def test_a_frame_graph_on_the_card_needs_k8(runs, monkeypatch):
    """A mesh on the card without K8's buffers (more than 8 ranks, several
    hosts, or the plain reference view) makes no frame graph: it raises
    before the warm-up (`slam_scan` runs such a mesh's frames through the
    host-branch step, `tests/test_torch_fused_allreduce.py`)."""
    final = runs["meshless"][0]
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        ss.frame_graph(final, CFG, mesh)          # a CPU mesh: host `if`s
        monkeypatch.setattr(mesh, "device", torch.device("cuda", 0))
        for m in (mesh, mesh.reference()):
            with pytest.raises(RuntimeError, match="K8"):
                ss.frame_graph(final, CFG, m)
        mesh.peers = object()
        mesh.check_capturable()
        with pytest.raises(RuntimeError, match="K8"):
            mesh.reference().check_capturable()
    finally:
        mesh.peers = None
        mesh.close()


class _FakeLibrary(dict):
    """K8's host entries, recording what they were asked."""

    def __init__(self):
        super().__init__(handle_bytes=4)
        self.log = []
        self["peer_alloc"] = self._alloc
        self["peer_handle"] = lambda ptr, h: self.log.append("handle") or 0
        self["peer_open"] = self._open
        self["peer_free"] = lambda ptr: self.log.append(("free", ptr)) or 0

    def _alloc(self, nbytes, ptr):
        self.log.append(("alloc", nbytes))
        ptr._obj.value = 4096
        return 0

    def _open(self, handle, ptr):
        self.log.append(("open", handle))
        ptr._obj.value = 8192
        return 0


@pytest.mark.parametrize("case", ["one_rank", "one_host", "two_hosts",
                                  "nine_ranks"])
def test_peer_buffers_only_where_k8_can_serve_the_group(case, monkeypatch):
    """`map_peers` maps every rank's buffer where the group is at most 8
    ranks on one host, exchanging handles only with more than one rank;
    with more ranks it allocates nothing, and with ranks on several hosts
    it frees its own buffer: None on every rank, the group's collectives."""
    fake = _FakeLibrary()
    monkeypatch.setattr(fused_allreduce, "_library", lambda: fake)
    monkeypatch.setattr(fused_allreduce.torch, "zeros",
                        lambda *a, **k: "epoch")
    world = {"one_rank": 1, "one_host": 2, "two_hosts": 2, "nine_ranks": 9}[case]
    hosts = ["a", "b"] if case == "two_hosts" else ["a", "a"]

    def gather(out, obj):
        out[:] = [(h, obj[1]) for h in hosts]

    monkeypatch.setattr(fused_allreduce.dist, "all_gather_object", gather)
    monkeypatch.setattr(fused_allreduce.socket, "gethostname", lambda: "a")
    peers = fused_allreduce.map_peers(0, world, torch.device("cuda", 0))
    if case == "nine_ranks":
        assert peers is None and fake.log == []
    elif case == "two_hosts":
        assert peers is None
        assert fake.log == [("alloc", fused_allreduce.area_bytes(2)),
                            "handle", ("free", 4096)]
    else:
        assert list(peers.bases) == [4096, 8192][:world]
        assert peers.world == world and peers.epoch == "epoch"
        assert [e for e in fake.log if e[0] == "open"] == (
            [] if world == 1 else [("open", b"\0" * 4)])


def test_the_host_branch_step_asks_for_the_plain_collectives(runs,
                                                              monkeypatch):
    """`_step(plain_collectives=True)` runs its frame over the mesh's
    reference view (the group's all-reduce); by default over the mesh."""
    seen = []

    def fake_frame(S, track, frame, imu, intrinsics, cfg, mesh=None):
        seen.append(mesh)
        raise StopIteration

    monkeypatch.setattr(ss, "_frame", fake_frame)
    final = runs["graph"][0]
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        mesh.peers = object()
        for plain in (False, True):
            with pytest.raises(StopIteration):
                ss._step(final, None, None, (None, False), None, CFG, mesh,
                         graph=object(), plain_collectives=plain)
        assert seen[0] is mesh
        assert seen[1] is not mesh and seen[1].peers is None
        assert seen[1].size == mesh.size
    finally:
        mesh.peers = None
        mesh.close()


def test_k8_takes_its_plain_version_on_the_cpu():
    """A CPU tensor goes through the plain version, the group's all-reduce:
    on one rank the tensor itself, in place."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        x = torch.randn(3, 7, generator=torch.Generator().manual_seed(0))
        y = x.clone()
        before = fused_allreduce.peer_allreduce.launches
        fused_allreduce.peer_allreduce(y, None)
        assert torch.equal(x, y)
        assert fused_allreduce.peer_allreduce.launches == before
    finally:
        mesh.close()
