"""ChunkedOdometry replays each frame in the `process_frame` call that hands
it in, on a working state that `flush` commits at the chunk's end (CPU):
the committed state stays the chunk's starting state until then, a fault
that restores it at a flush still restarts the next chunk from it, frames
handed from one buffer the caller rewrites after each call give the
whole-sequence scan's results, and a ragged tail flushes as a short chunk."""

import json

import numpy as np
import pytest
import torch

from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.config import FrontendConfig, TrackingConfig
from jetracer_orbslam2_torch.io.synthetic import generate_sequence
from jetracer_orbslam2_torch.models import odometry as todom

N, H, W, CHUNK, SEED = 12, 120, 160, 4, 3      # 11 tracked frames: 4, 4, 3
FCFG = FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=256)
TCFG = TrackingConfig()


@pytest.fixture(scope="module")
def arc():
    seq = generate_sequence(n_frames=N, shape=(H, W), device="cpu")
    gray, depth, intr = seq.gray.numpy(), seq.depth.numpy(), seq.intrinsics.numpy()
    st = todom.init_state(gray[0], depth[0], intr, FCFG, TCFG, seed=SEED,
                          device="cpu")
    _, poses, ok = todom.odometry_scan(st, gray[1:], depth[1:], intr, FCFG, TCFG)
    return gray, depth, intr, poses.numpy(), ok.numpy()


def _chunked(intr) -> todom.ChunkedOdometry:
    return todom.ChunkedOdometry(intr, FCFG, TCFG, chunk_size=CHUNK, seed=SEED,
                                 device="cpu")


def test_the_state_is_committed_at_the_chunk_end(arc):
    gray, depth, intr, poses, _ = arc
    ch = _chunked(intr)
    ch.process_frame(gray[0], depth[0])
    start = ch.state
    for i in range(1, CHUNK):
        ch.process_frame(gray[i], depth[i])
        # one step a call, on the working state; the committed one waits
        assert ch.state is start
        assert ch.frames_replayed_on_arrival == i
        assert ch._work.graph.eager_calls == i
        assert len(ch._ok) == 1
    ch.process_frame(gray[CHUNK], depth[CHUNK])
    assert ch.state is not start and int(ch.state.frame_idx) == CHUNK
    assert ch._work is None and len(ch._ok) == 2
    np.testing.assert_array_equal(ch._poses[-1], poses[:CHUNK])
    assert ch.staging_waits == 0


def test_a_flush_that_restores_the_state_restarts_the_next_chunk(
        arc, monkeypatch):
    """The benchmark's planted fault (`slambench/tests/faults.py`,
    `frozen_state`): `flush` wrapped to put back the state it found."""
    gray, depth, intr, poses, _ = arc
    flush = todom.ChunkedOdometry.flush

    def stuck(self):
        before = self.state
        flush(self)
        self.state = before

    monkeypatch.setattr(todom.ChunkedOdometry, "flush", stuck)
    ch = _chunked(intr)
    for i in range(N):
        ch.process_frame(gray[i], depth[i])
    ch.flush()
    got, _ = ch.result()
    assert int(ch.state.frame_idx) == 0
    np.testing.assert_array_equal(got[1:CHUNK + 1], poses[:CHUNK])
    for k in (1, 2):                    # each later chunk starts at frame 0
        rows = slice(1 + k * CHUNK, 1 + (k + 1) * CHUNK)
        assert not np.array_equal(got[rows], poses[rows.start - 1:rows.stop - 1])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_a_reused_host_buffer_gives_the_scan(arc, kind):
    gray, depth, intr, poses, ok = arc
    if kind == "numpy":
        buf_g, buf_d = np.empty_like(gray[0]), np.empty_like(depth[0])

        def fill(i):
            buf_g[...], buf_d[...] = gray[i], depth[i]
    else:
        buf_g, buf_d = torch.empty(H, W), torch.empty(H, W)

        def fill(i):
            buf_g.copy_(torch.from_numpy(gray[i]))
            buf_d.copy_(torch.from_numpy(depth[i]))
    ch = _chunked(intr)
    for i in range(N):
        fill(i)
        ch.process_frame(buf_g, buf_d)
        fill((i + 5) % N)               # the caller's next use of its buffer
    ch.flush()
    got, got_ok = ch.result()
    np.testing.assert_array_equal(got[1:], poses)
    np.testing.assert_array_equal(got_ok[1:], ok)


def test_a_ragged_tail_flushes_as_a_short_chunk(arc):
    gray, depth, intr, poses, ok = arc
    ch = _chunked(intr)
    for i in range(N):
        ch.process_frame(gray[i], depth[i])
    assert ch.result()[0].shape == (1 + 2 * CHUNK, 4, 4)
    ch.flush()
    ch.flush()                          # nothing pending: nothing happens
    got, got_ok = ch.result()
    assert got.shape == (N, 4, 4) and [len(p) for p in ch._poses] == [1, 4, 4, 3]
    np.testing.assert_array_equal(got[0], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(got[1:], poses)
    np.testing.assert_array_equal(got_ok[1:], ok)
    assert int(ch.state.frame_idx) == N - 1
    assert ch.frames_replayed_on_arrival == N - 1


def test_cli_reports_the_entry_counters(capsys):
    rc = trun.main(["--synthetic", "7", "--mode", "odometry", "--device", "cpu",
                    "--levels", "2", "--max-keypoints", "256", "--json",
                    "--chunked", "3"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["counters"] == {"staging_waits": 0,
                                  "frames_replayed_on_arrival": 6}
    assert "spans" in report
