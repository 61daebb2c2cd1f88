"""Runtime of the PyTorch port vs the JAX package (CPU): the frame pipeline's
order and drop policy, the watchdog, the stage timers, checkpoints that
either package writes and the other reads, and the CLI's host loop with
`--checkpoint` / `--resume`."""

import json
import os
import random
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import MapConfig as JMapConfig
from jetracer_orbslam2_tpu.models.backend import map as jmap
from jetracer_orbslam2_tpu.runtime.checkpoint import (
    load_checkpoint as j_load, save_checkpoint as j_save)

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.models.backend import map as tmap
from jetracer_orbslam2_torch.models.frontend import Features
from jetracer_orbslam2_torch.runtime import (
    FramePipeline, load_checkpoint, save_checkpoint)
from jetracer_orbslam2_torch.runtime.liveness import Watchdog
from jetracer_orbslam2_torch.utils.timing import StageTimers, Timer

from _torch_port_util import jax_map_to_numpy

TUM = os.path.join(os.path.dirname(__file__), "fixtures", "tum_tiny")
NARROW = ["--levels", "2", "--max-keypoints", "128"]
# the host loop's report in the JAX CLI (jetracer_orbslam2_tpu/run.py:400-427
# with no mesh), to which the port adds "stereo" and "device"
JAX_REPORT_KEYS = {
    "mode", "frames", "fps", "keyframes", "landmarks", "loops", "relocs",
    "tracked_frac", "attitude_rad", "watchdog_stalls", "ate_rmse_m",
    "rpe_drift_pct", "rpe_rot_deg_per_m"}
JAX_TELEMETRY_KEYS = {"telemetry_sent", "telemetry_dropped"}


def test_pipeline_preserves_order_multiworker():
    rng = random.Random(0)
    delays = [rng.uniform(0, 0.003) for _ in range(200)]

    def slow_transform(x):
        time.sleep(delays[x])       # induce decode races
        return x * 2

    pipe = FramePipeline(range(200), transform=slow_transform,
                         capacity=8, num_workers=4)
    out = list(pipe)
    assert out == [2 * i for i in range(200)]
    assert pipe.stats.consumed == pipe.stats.produced == 200
    assert pipe.stats.dropped == 0
    assert pipe.timers.summary()["decode"]["n"] == 200


def test_pipeline_drop_policy():
    def source():
        yield from range(50)

    pipe = FramePipeline(source(), capacity=2, drop_when_full=True,
                         num_workers=1)
    seen = []
    for x in pipe:
        time.sleep(0.01)       # consumer slower than producer
        seen.append(x)
    # drops happened, but whatever arrived is in order
    assert seen == sorted(seen)
    assert pipe.stats.dropped > 0
    assert pipe.stats.consumed == len(seen)
    assert pipe.stats.consumed + pipe.stats.dropped == 50


def test_pipeline_hands_a_worker_error_to_the_consumer():
    """A frame that fails to load ends the loop with its error (it does not
    leave the consumer waiting), and no worker is left running."""
    def load(i):
        if i == 7:
            raise ValueError("corrupt frame 7")
        return i

    before = set(threading.enumerate())
    pipe = FramePipeline(range(20), transform=load, capacity=4, num_workers=2)
    got = []
    with pytest.raises(ValueError, match="corrupt frame 7"):
        for x in pipe:
            got.append(x)
    assert got == list(range(len(got))) and len(got) <= 7
    workers = set(threading.enumerate()) - before
    for th in workers:
        th.join(timeout=5)
    assert not any(th.is_alive() for th in workers)


def test_watchdog_counts_one_stall_per_episode():
    ages = []
    dog = Watchdog(timeout_s=0.3, on_stall=ages.append,
                   check_interval_s=0.01).start()
    try:
        time.sleep(1.0)                     # one long stall: one episode
        assert dog.stalls == 1
        for _ in range(10):                 # beats in time: no stall
            dog.beat()
            time.sleep(0.02)
        assert dog.stalls == 1
        time.sleep(1.0)                     # a second episode
        assert dog.stalls == 2
    finally:
        dog.close()
    assert len(ages) == 2 and min(ages) > 0.3


def test_timer_stop_waits_only_for_cuda_results(monkeypatch):
    """`Timer.stop(result)` waits for the CUDA devices of `result`: on CPU
    tensors, None and containers of them it waits for nothing."""
    def no_wait(*a):
        raise AssertionError("synchronize called for a CPU result")

    monkeypatch.setattr(torch.cuda, "synchronize", no_wait)
    timers = StageTimers()
    x = torch.ones(3)
    t = timers.timer("cpu").start()
    dt = t.stop(x)
    assert dt >= 0.0 and timers.stages["cpu"].n == 1
    Timer().start().stop(None)
    Timer().start().stop((x, [x, {"a": x}], Features(*[x] * 8)))
    out = timers.time("add", torch.add, x, x)
    assert torch.equal(out, 2 * x)
    summary = timers.summary()
    assert set(summary) == {"cpu", "add"} and summary["add"]["n"] == 1
    with timers.timer("ctx"):
        pass
    assert timers.summary()["ctx"]["n"] == 1


def _filled_map_fields(seed):
    """Every field of a small map filled with values of its dtype: slots in
    use, descriptors as uint32 with the top bit set."""
    cfg = JMapConfig(max_keyframes=6, max_landmarks=40, max_obs=96,
                     max_loop_edges=4, max_dead_keyframes=4)
    empty = jax_map_to_numpy(jmap.init_map(cfg, 16))
    rng = np.random.default_rng(seed)
    out = {}
    for name, a in empty.items():
        if a.dtype == np.uint32:
            v = rng.integers(0, 2 ** 32, a.shape, dtype=np.uint64).astype(np.uint32)
            v.flat[0] = 0xFFFFFFFF
            v.flat[1] = 0x80000001
        elif a.dtype == np.bool_:
            v = rng.random(a.shape) > 0.5
        elif a.dtype == np.int32:
            v = rng.integers(-5, 60, a.shape).astype(np.int32)
        else:
            v = rng.normal(size=a.shape).astype(a.dtype)
        out[name] = v
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_interchanges_with_jax(direction, tmp_path):
    """A checkpoint written by either package loads in the other, field for
    field, dtypes included (descriptors uint32 on disk and in JAX, their bit
    patterns as int32 in the port)."""
    fields = _filled_map_fields(1 if direction == "jax_to_port" else 2)
    path = str(tmp_path / "ck")
    extra = {"frames": 42, "note": "x"}
    if direction == "jax_to_port":
        j_save(path, jmap.MapState(**{k: jnp.asarray(v) for k, v in fields.items()}),
               extra=extra)
        m, got_extra = load_checkpoint(path, device="cpu")
        assert m.kf_desc.dtype == torch.int32 and m.lm_desc.device.type == "cpu"
        got = convert.map_state_to_numpy(m)
    else:
        m = convert.map_state_from_numpy(fields, "cpu")
        save_checkpoint(path, m, extra=extra)
        jm, got_extra = j_load(path)
        got = jax_map_to_numpy(jm)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            assert data["map_kf_desc"].dtype == np.uint32
            assert data["map_lm_desc"].dtype == np.uint32
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        assert meta["format"] == 1 and meta["fields"] == list(jmap.MapState._fields)
    assert got_extra == extra
    assert list(got) == list(jmap.MapState._fields) == list(tmap.MapState._fields)
    for name, want in fields.items():
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_checkpoint_loads_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    fields = _filled_map_fields(3)
    path = str(tmp_path / "ck")
    save_checkpoint(path, convert.map_state_from_numpy(fields, "cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(path)
    m, extra = load_checkpoint(path, device="cpu")
    assert extra == {} and int(m.num_kf) == int(fields["num_kf"])


def _run(argv, capsys):
    assert trun.main(argv + ["--json", "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_checkpoint_then_resume(capsys, tmp_path):
    """The host loop saves its final map with --checkpoint and starts from it
    with --resume (the JAX CLI test's check: keyframes do not fall); the
    report has the JAX report's keys plus the port's stereo, device and
    (--json) spans."""
    ck = str(tmp_path / "ck")
    first = _run(["--dataset", TUM, "--checkpoint", ck] + NARROW, capsys)
    assert set(first) == JAX_REPORT_KEYS | {"checkpoint", "stereo", "device",
                                            "spans"}
    # the host loop's workers decode, its tracking step is a graph call
    assert {"stage.decode", "graph.replay"} <= set(first["spans"])
    assert first["checkpoint"] == ck and first["watchdog_stalls"] == 0
    assert first["frames"] == 24 and first["keyframes"] >= 2
    saved, extra = load_checkpoint(ck, device="cpu")
    assert extra == {"frames": 24} and int(saved.num_kf) == first["keyframes"]
    resumed = _run(["--dataset", TUM, "--resume", ck, "--max-frames", "8"]
                   + NARROW, capsys)
    assert set(resumed) == JAX_REPORT_KEYS | {"stereo", "device", "spans"}
    assert resumed["frames"] == 8
    assert resumed["keyframes"] >= first["keyframes"]
    assert resumed["tracked_frac"] == 1.0


def test_cli_telemetry_without_a_client(capsys):
    """--telemetry with no client connected: every frame is still published
    (sent or dropped for budget), and the report adds the JAX report's
    telemetry keys (and the port's stereo, device and spans)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    report = _run(["--dataset", TUM, "--max-frames", "6", "--telemetry",
                   str(port)] + NARROW, capsys)
    assert set(report) == (JAX_REPORT_KEYS | JAX_TELEMETRY_KEYS
                           | {"stereo", "device", "spans"})
    assert report["telemetry_sent"] + report["telemetry_dropped"] == 6


def test_decode_threads_share_one_native_build_and_count_every_file():
    """Decode threads reach the native decoder's first load together: each
    gets the library (none falls back to PIL), and every decode is counted.
    More threads than cores, with a short switch interval."""
    import sys

    from jetracer_orbslam2_torch.io import datasets as tds
    from jetracer_orbslam2_torch.io import native_loader

    if not native_loader.available():
        pytest.skip(f"native decoder unavailable: {native_loader.build_error()}")
    png = os.path.join(TUM, "depth", sorted(os.listdir(os.path.join(TUM, "depth")))[0])
    saved = (native_loader._lib, native_loader._lib_tried, native_loader._build_error)
    native_loader._lib, native_loader._lib_tried = None, False
    before = dict(tds.DECODED)
    seen, n_threads, reps = [], 4 * (os.cpu_count() or 1), 10
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(reps):
                seen.append(tds._imread_depth16(png, 1 / 5000.0).shape)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old_interval)
        native_loader._lib, native_loader._lib_tried, native_loader._build_error = saved
    assert len(seen) == n_threads * reps and len(set(seen)) == 1
    assert tds.DECODED["native"] - before["native"] == n_threads * reps
    assert tds.DECODED["pil"] == before["pil"]
