"""Multi-PROCESS sharded BA of the PyTorch port on the CPU: four OS
processes, a FileStore, gloo collectives, one landmark block each.  Run
through `python -m jetracer_orbslam2_torch.parallel.distributed_worker`
(the counterpart of `scripts/distributed_ba_worker.py`), held to the JAX
package's bars (`tests/test_distributed.py`, `tests/test_ba_sharded.py`,
`tests/test_slam_scan.py`, `tests/test_cli.py`): the ranks agree bit for bit,
the result is the single-process solver's, and the live `Slam`, `slam_scan`
and `ChunkedSlam` with the mesh are the meshless runs.  Then the CLI's
`--mesh 1` and `--distributed` in one process."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jetracer_orbslam2_tpu.config import BAConfig as JBAConfig
from jetracer_orbslam2_tpu.parallel import make_mesh as j_make_mesh
from jetracer_orbslam2_tpu.parallel import (
    prepare_sharded_problem as j_prepare, sharded_bundle_adjust as j_sba)
from jetracer_orbslam2_tpu.parallel.bench_ba import (
    make_synthetic_ba as j_make_synthetic_ba)

from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.config import BAConfig
from jetracer_orbslam2_torch.io.synthetic import generate_sequence
from jetracer_orbslam2_torch.models import slam_scan as ss
from jetracer_orbslam2_torch.models.backend.ba import bundle_adjust
from jetracer_orbslam2_torch.models.slam import Slam
from jetracer_orbslam2_torch.parallel import distributed_worker as worker
from jetracer_orbslam2_torch.parallel.bench_ba import make_synthetic_ba

# small tensors only: see tests/_torch_port_util.py
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tum_tiny")
WORLD = 4
close = np.testing.assert_allclose


def _meshless():
    """Slam, slam_scan and ChunkedSlam without a mesh on the worker's frames
    and configuration."""
    cfg = worker.slam_config()
    seq = generate_sequence(n_frames=worker.SLAM_FRAMES,
                            shape=worker.SLAM_SHAPE, device="cpu")
    slam = Slam(cfg, seq.intrinsics, device="cpu")
    for i in range(worker.SLAM_FRAMES):
        slam.process_frame(seq.gray[i], seq.depth[i])
    st = ss.init_scan_state(seq.gray[0], seq.depth[0], seq.intrinsics, cfg,
                            device="cpu")
    final, scan = ss.slam_scan(st, seq.gray[1:], seq.depth[1:],
                               seq.intrinsics, cfg)
    ch = ss.ChunkedSlam(cfg, seq.intrinsics, chunk_size=4, device="cpu")
    for i in range(worker.SLAM_FRAMES):
        ch.process_frame(seq.gray[i], seq.depth[i])
    ch.flush()
    return {
        "slam": {"kf_pose": slam.m.kf_pose.numpy(), "poses": slam.result().poses,
                 "num_kf": int(slam.m.num_kf)},
        "scan": {"kf_pose": final.m.kf_pose.numpy(), "T_rel": scan.T_rel.numpy(),
                 "num_kf": int(final.m.num_kf)},
        "chunked": {"kf_pose": ch.state.m.kf_pose.numpy(), "poses": ch.result(),
                    "num_kf": int(ch.state.m.num_kf)},
    }


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(per-rank JSON reports, the meshless runs): the four workers run
    while this process computes the meshless runs."""
    store = tmp_path_factory.mktemp("store") / "filestore"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m",
             "jetracer_orbslam2_torch.parallel.distributed_worker",
             f"file://{store}", str(WORLD), str(rank), "--device", "cpu",
             "--slam"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        for rank in range(WORLD)]
    try:
        meshless = _meshless()
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs, meshless


def test_four_processes_form_a_group(four_ranks):
    outs, _ = four_ranks
    assert [o["rank"] for o in outs] == list(range(WORLD))
    for o in outs:
        assert o["world_size"] == WORLD and o["backend"] == "gloo"
        assert o["device"] == "cpu" and "launches" not in o


def test_ranks_agree_bitwise(four_ranks):
    outs, _ = four_ranks
    for o in outs[1:]:
        assert o["digest"] == outs[0]["digest"]
        assert o["slam_digest"] == outs[0]["slam_digest"]
        assert o["poses_t"] == outs[0]["poses_t"]
        assert o["cost_final"] == outs[0]["cost_final"]


def test_matches_single_process_solver(four_ranks):
    outs, _ = four_ranks
    prob, intr = make_synthetic_ba(n_poses=4, n_landmarks=64, obs_per_lm=4,
                                   device="cpu")
    poses_1, _, _ = bundle_adjust(prob, intr, BAConfig(iters=8), device="cpu")
    close(np.asarray(outs[0]["poses_t"]), poses_1[:, :3, 3].numpy(),
          rtol=0, atol=2e-3)
    assert outs[0]["cost_final"] < 0.1 * outs[0]["cost0"]


def test_matches_the_jax_sharded_solver_on_four_devices(four_ranks):
    outs, _ = four_ranks
    jprob, jintr = j_make_synthetic_ba(n_poses=4, n_landmarks=64, obs_per_lm=4)
    jp, _, jt = j_sba(j_prepare(jprob, WORLD), jintr, JBAConfig(iters=8),
                      j_make_mesh(WORLD))
    close(np.asarray(outs[0]["poses_t"]), np.asarray(jp)[:, :3, 3],
          rtol=0, atol=5e-3)
    close([outs[0]["cost0"], outs[0]["cost_final"]],
          np.asarray(jt)[[0, -1]], rtol=5e-3)


@pytest.mark.parametrize("run", ["slam", "scan", "chunked"])
def test_live_system_with_the_mesh_matches_the_meshless_run(four_ranks, run):
    """`Slam`, `slam_scan` and `ChunkedSlam` with a four-rank mesh route
    every windowed BA through `sharded_local_ba`: the same keyframes, the
    keyframe poses to 2e-3 and the trajectory to 5e-3 (not bit for bit: the
    all-reduce sums in another order)."""
    outs, meshless = four_ranks
    got, want = outs[0]["slam"][run], meshless[run]
    assert got["ba_edges_dropped"] == 0
    assert got["num_kf"] == want["num_kf"] >= 3
    close(np.asarray(got["kf_pose"]), want["kf_pose"], rtol=0, atol=2e-3)
    traj = "T_rel" if run == "scan" else "poses"
    close(np.asarray(got[traj]), want[traj], rtol=0, atol=5e-3)


@pytest.mark.parametrize("extra", [[], ["--chunked", "4"]])
def test_cli_mesh_one_on_the_cpu(extra, capsys):
    """`--mesh 1` builds a one-rank group on the run's device, shards every
    windowed BA over it and reports the mesh; the group is gone after."""
    argv = ["--dataset", FIXTURE, "--levels", "2", "--max-keypoints", "128",
            "--json", "--device", "cpu"] + extra
    assert trun.main(argv + ["--mesh", "1"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not dist.is_initialized()
    assert report["mode"].startswith("slam")
    assert report["mesh_devices"] == 1 and report["ba_edges_dropped"] == 0
    assert report["frames"] == 24 and report["keyframes"] >= 2
    assert report["ate_rmse_m"] < 0.05, report


def test_cli_distributed_flag_single_process(capsys, monkeypatch):
    """--distributed with nothing set falls back to the single-process path
    (the `init_distributed` contract)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert trun.main(["--dataset", FIXTURE, "--levels", "2",
                      "--max-keypoints", "128", "--distributed",
                      "--max-frames", "6", "--json", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 6 and "mesh_devices" not in report
    assert not dist.is_initialized()
