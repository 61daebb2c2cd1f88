"""Package hygiene of the PyTorch port: it imports no JAX and nothing of the
JAX package, chooses the card by default, and refuses what it cannot run."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.utils import cuda_build
from jetracer_orbslam2_torch.utils.device import resolve_device
from jetracer_orbslam2_torch.utils.precision import set_exact_f32

# small tensors only: see tests/_torch_port_util.py
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "jetracer_orbslam2_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jetracer_orbslam2_tpu\b"
    r"|from\s+jetracer_orbslam2_tpu\b)", re.M)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_name_no_jax_import():
    files = _sources()
    assert len(files) > 30
    names = {str(f.relative_to(ROOT)) for f in files}
    for new in ("models/backend/ba.py", "models/backend/map.py",
                "models/backend/pose_graph.py", "models/slam.py",
                "ops/fused_ba.py", "parallel/bench_ba.py", "convert.py",
                "models/backend/loop.py", "models/imu.py", "models/slam_scan.py",
                "ops/fused_patches.py", "models/stereo.py", "io/datasets.py",
                "io/native_loader.py", "runtime/__init__.py",
                "runtime/pipeline.py", "runtime/liveness.py", "runtime/bson.py",
                "runtime/telemetry.py", "runtime/checkpoint.py",
                "ops/overlay.py", "utils/timing.py", "parallel/mesh.py",
                "parallel/ba_sharded.py", "parallel/distributed_worker.py",
                "ops/fused_rigid.py", "utils/step_graph.py",
                "ops/fused_polish.py"):
        assert f"jetracer_orbslam2_torch/{new}" in names
    for path in files:
        assert not _FORBIDDEN.search(path.read_text()), path


_IMPORT_ALL = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "jetracer_orbslam2_tpu"):
            raise ImportError("blocked: " + name)
        return None

for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[name]
sys.meta_path.insert(0, Block())
sys.modules["jax"] = None

import jetracer_orbslam2_torch as pkg
count = 0
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    count += 1
for name in ("models.stereo", "io.datasets", "io.native_loader",
             "runtime.pipeline", "runtime.liveness", "runtime.bson",
             "runtime.telemetry", "runtime.checkpoint", "ops.overlay",
             "utils.timing", "parallel.mesh", "parallel.ba_sharded",
             "parallel.distributed_worker", "ops.fused_rigid",
             "utils.step_graph", "ops.fused_polish"):
    assert "jetracer_orbslam2_torch." + name in sys.modules, name
import chip_smoke
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jaxlib", "jetracer_orbslam2_tpu")
          or (m.split(".")[0] == "jax" and sys.modules[m] is not None)]
assert not leaked, leaked
print("imported", count)
"""


def test_port_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 30


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    import numpy as np
    from jetracer_orbslam2_torch.config import FrontendConfig, TrackingConfig
    from jetracer_orbslam2_torch.io.synthetic import generate_sequence
    from jetracer_orbslam2_torch.models.frontend import (
        frontend_gray_depth, frontend_rgbd)
    from jetracer_orbslam2_torch.models.odometry import ChunkedOdometry, init_state

    g = np.zeros((48, 64), np.float32)
    intr = np.float32([50, 50, 32, 24])
    f, tr = FrontendConfig(height=48, width=64, num_levels=1), TrackingConfig()
    for call in (
        lambda: generate_sequence(2, (48, 64)),
        lambda: frontend_gray_depth(g, g, intr, f),
        # a CPU tensor does not choose the CPU: only device="cpu" does
        lambda: frontend_gray_depth(torch.from_numpy(g), torch.from_numpy(g),
                                    torch.from_numpy(intr), f),
        lambda: frontend_rgbd(torch.zeros(48, 64, 3), torch.from_numpy(g),
                              torch.from_numpy(intr), f),
        lambda: init_state(g, g, intr, f, tr),
        lambda: ChunkedOdometry(intr, f, tr),
        lambda: trun.main(["--synthetic", "2", "--mode", "odometry"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_backend_entry_points_default_to_the_card():
    """Every entry point of the BA / map / pose-graph slice runs on cuda:0
    unless asked for the CPU, wherever its inputs lie."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    from jetracer_orbslam2_torch.config import (
        BAConfig, MapConfig, PoseGraphConfig, SystemConfig)
    from jetracer_orbslam2_torch.models import slam
    from jetracer_orbslam2_torch.models.backend import ba, map as map_mod
    from jetracer_orbslam2_torch.models.backend import pose_graph as pg
    from jetracer_orbslam2_torch.models.frontend import Features
    from jetracer_orbslam2_torch.parallel import ba_sharded, bench_ba

    prob, intr = bench_ba.make_synthetic_ba(3, 8, 2, device="cpu")
    obs, _ = ba.edges_to_dense(3, 8, *prob[2:8])
    m = map_mod.init_map(MapConfig(max_keyframes=2, max_landmarks=8, max_obs=16),
                         4, device="cpu")
    k = 4
    feats = Features(
        xy=torch.zeros(k, 2), level=torch.zeros(k, dtype=torch.int32),
        score=torch.zeros(k), angle=torch.zeros(k),
        desc=torch.zeros(k, 8, dtype=torch.int32),
        valid=torch.ones(k, dtype=torch.bool), points=torch.ones(k, 3),
        has_point=torch.ones(k, dtype=torch.bool))
    graph = pg.PoseGraphProblem(
        poses=torch.eye(4).repeat(2, 1, 1), edge_i=torch.tensor([0]),
        edge_j=torch.tensor([1]), edge_T=torch.eye(4)[None],
        edge_weight=torch.ones(1), fixed=torch.tensor([True, False]))
    none = torch.zeros(k, dtype=torch.bool)
    calls = {
        "make_synthetic_ba": lambda **kw: bench_ba.make_synthetic_ba(3, 8, 2, **kw),
        "bundle_adjust": lambda **kw: ba.bundle_adjust(
            prob, intr, BAConfig(iters=1), **kw),
        "lm_run_dense": lambda **kw: ba.lm_run_dense(
            prob.poses, prob.points, obs, prob.fixed,
            torch.ones(8, dtype=torch.bool), intr, BAConfig(iters=1), **kw),
        "time_ba": lambda **kw: bench_ba.time_ba(
            prob, intr, BAConfig(iters=1), reps=1, **kw),
        "prepare_sharded_problem": lambda **kw: ba_sharded.prepare_sharded_problem(
            prob, 2, **kw),
        "time_sharded_ba": lambda **kw: bench_ba.time_sharded_ba(
            prob, intr, 1, BAConfig(iters=1), reps=1, **kw),
        "optimize_pose_graph": lambda **kw: pg.optimize_pose_graph(
            graph, PoseGraphConfig(iters=1), **kw),
        "init_map": lambda **kw: map_mod.init_map(MapConfig(), 4, **kw),
        "insert_keyframe": lambda **kw: map_mod.insert_keyframe(
            m, feats, torch.eye(4), 0, ~none, torch.zeros(k, dtype=torch.int32),
            none, **kw),
        "compact_map": lambda **kw: map_mod.compact_map(m, 2, 0, **kw),
        "associate_landmarks": lambda **kw: map_mod.associate_landmarks(
            m, feats, torch.eye(4), intr, **kw),
        "local_ba": lambda **kw: slam.local_ba(
            m, intr, 2, SystemConfig(ba=BAConfig(iters=1)), **kw),
    }
    for name, call in calls.items():
        # CPU tensors do not choose the CPU ...
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        # ... only device="cpu" does
        call(device="cpu")


def test_ba_kernel_source_and_wrapper_contract():
    from jetracer_orbslam2_torch.ops import fused_ba

    path = cuda_build.library_path("ba_fused")
    assert re.fullmatch(r"ba_fused-[0-9a-f]{16}\.so", path.name)
    src = (PORT / "csrc" / "ba_fused.cu").read_text()
    for entry in ("ba_assemble_launch", "ba_backsub_launch",
                  "ba_workspace_floats", "ba_max_poses"):
        assert re.search(r'extern "C" [a-z ]+ ' + entry + r"\(", src), entry
    cap = int(re.search(r"constexpr int MAX_POSES = (\d+);", src).group(1))
    assert cap == fused_ba.MAX_POSES == 16
    # plain FP32 sums in a fixed order: no atomics, no tensor cores, no
    # library call, no PyTorch header
    for banned in ("atomicAdd", "wmma", "mma.sync", "wgmma", "cublas",
                   "torch/extension.h", "#include <ATen"):
        assert banned not in src, banned
    wrapper = (PORT / "ops" / "fused_ba.py").read_text()
    assert "torch.compile" not in wrapper and "import triton" not in wrapper
    # each wrapper counts its launch once, through step_graph.note_launch
    # (eager, or as a node of a captured step graph)
    assert wrapper.count("note_launch(fused_normal_schur)") == 1
    assert wrapper.count("note_launch(fused_backsub)") == 1


def test_set_exact_f32():
    torch.backends.cudnn.allow_tf32 = True
    set_exact_f32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("argv", [
    ["--mode", "slam"],                          # no source
    ["--mode", "odometry"],
    ["--synthetic", "4", "--mesh", "4"],
])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    """No source; `--mesh 4` in a one-process run (a mesh of N ranks needs N
    processes: the message names `torch.distributed.run`)."""
    assert trun.main(argv + ["--device", "cpu"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    if "--mesh" in argv:
        assert ("--mesh 4 needs a group of 4 processes" in captured.err
                and "python -m torch.distributed.run --nproc-per-node 4"
                in captured.err and "--distributed" in captured.err)
    else:
        assert "need --dataset or --synthetic" in captured.err


@pytest.mark.parametrize("flag", [
    ["--resume", "/nonexistent"], ["--telemetry", "0"],
    ["--telemetry-no-image"]])
def test_cli_runtime_flags_as_the_jax_cli_reads_them(flag, capsys):
    """The runtime's flags are ported: a missing checkpoint directory raises
    the JAX CLI's FileNotFoundError; `--telemetry 0` (the default port 0)
    and `--telemetry-no-image` alone run with no telemetry."""
    import json

    argv = ["--synthetic", "2", "--json", "--device", "cpu", "--levels", "2",
            "--max-keypoints", "128"] + flag
    if flag[0] == "--resume":
        with pytest.raises(FileNotFoundError, match="/nonexistent"):
            trun.main(argv)
        return
    assert trun.main(argv) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["mode"] == "slam" and report["frames"] == 2
    assert report["watchdog_stalls"] == 0
    assert "telemetry_sent" not in report and "checkpoint" not in report


@pytest.mark.parametrize("mode", ["slam", "odometry"])
def test_cli_unknown_dataset_layout_raises(mode):
    """A directory that is no TUM, EuRoC or KITTI sequence: the JAX package's
    ValueError from `open_dataset`, in both modes."""
    with pytest.raises(ValueError,
                       match="unrecognized dataset layout at /nonexistent"):
        trun.main(["--dataset", "/nonexistent", "--mode", mode,
                   "--device", "cpu"])


def test_stereo_and_dataset_entry_points_default_to_the_card():
    """The stereo and dataset slice's entry points run on cuda:0 unless asked
    for the CPU, wherever their inputs lie."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    import numpy as np
    from jetracer_orbslam2_torch.config import FrontendConfig
    from jetracer_orbslam2_torch.io import synthetic
    from jetracer_orbslam2_torch.models.stereo import frontend_stereo
    from jetracer_orbslam2_torch.ops.align import align_depth_to_color

    g = torch.zeros(48, 64)
    intr = torch.tensor([50.0, 50.0, 32.0, 24.0])
    f = FrontendConfig(height=48, width=64, num_levels=1, max_keypoints=16)
    calls = {
        "frontend_stereo": lambda **kw: frontend_stereo(g, g, intr, 0.1, f, **kw),
        "generate_stereo_sequence": lambda **kw:
            synthetic.generate_stereo_sequence(2, (48, 64), **kw),
        "generate_stereo_lap_sequence": lambda **kw:
            synthetic.generate_stereo_lap_sequence(2, (48, 64), lap_frames=8,
                                                   **kw),
        "align_depth_to_color": lambda **kw: align_depth_to_color(
            g, intr, intr, torch.eye(4), (48, 64), **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")
    fixture = str(ROOT / "tests" / "fixtures" / "kitti_tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--dataset", fixture, "--max-frames", "2"])
    assert np.isfinite(align_depth_to_color(
        g, intr, intr, torch.eye(4), (48, 64), device="cpu").numpy()).all()


@pytest.mark.parametrize("extra,mode", [
    ([], "slam"), (["--chunked", "3"], "slam-chunked3")])
def test_cli_runs_slam_by_default(extra, mode, capsys):
    """`--mode slam` is the default: the host loop, or ChunkedSlam with
    --chunked, on the CLI's 640x480 frames (a narrow front-end keeps the CPU
    run short)."""
    import json

    argv = ["--synthetic", "4", "--json", "--device", "cpu", "--levels", "2",
            "--max-keypoints", "256"]
    assert trun.main(argv + extra) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["mode"] == mode and report["frames"] == 4
    assert report["device"] == "cpu"
    for key in ("fps", "tracked_frac", "keyframes", "landmarks", "loops",
                "relocs", "ate_rmse_m", "rpe_drift_pct", "rpe_rot_deg_per_m"):
        assert key in report, key
    assert report["keyframes"] >= 1 and report["loops"] == 0
    assert report["tracked_frac"] == 1.0 and report["landmarks"] > 100
    assert 0.0 <= report["ate_rmse_m"] < 0.05


def test_slam_entry_points_default_to_the_card():
    """Every entry point of the SLAM slice runs on cuda:0 unless asked for
    the CPU, wherever its inputs lie."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA device")
    import numpy as np
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, LoopClosureConfig, MapConfig, PoseGraphConfig,
        SystemConfig)
    from jetracer_orbslam2_torch.io.synthetic import generate_lap_sequence
    from jetracer_orbslam2_torch.models import slam, slam_scan
    from jetracer_orbslam2_torch.models.backend import loop, map as map_mod
    from jetracer_orbslam2_torch.models.frontend import Features

    k = 4
    mcfg = MapConfig(max_keyframes=4, max_landmarks=8, max_obs=16,
                     max_loop_edges=2, max_dead_keyframes=4)
    cfg = SystemConfig(
        frontend=FrontendConfig(height=48, width=64, num_levels=1,
                                max_keypoints=k), map=mcfg)
    feats = Features(
        xy=torch.zeros(k, 2), level=torch.zeros(k, dtype=torch.int32),
        score=torch.zeros(k), angle=torch.zeros(k),
        desc=torch.zeros(k, 8, dtype=torch.int32),
        valid=torch.ones(k, dtype=torch.bool), points=torch.ones(k, 3),
        has_point=torch.ones(k, dtype=torch.bool))
    m = map_mod.init_map(mcfg, k, device="cpu")
    none = torch.zeros(k, dtype=torch.bool)
    for i in range(2):
        m, _ = map_mod.insert_keyframe(
            m, feats, torch.eye(4), i, ~none, torch.zeros(k, dtype=torch.int32),
            none, device="cpu")
    intr = torch.tensor([50.0, 50.0, 32.0, 24.0])
    g = np.zeros((48, 64), np.float32)
    lc = LoopClosureConfig(topn=1, world_max_obs=4)
    calls = {
        "compact_keyframes": lambda **kw: map_mod.compact_keyframes(
            m, 0.9, 3, 1, 4, **kw),
        "retrieve": lambda **kw: loop.retrieve(m, 1, 0.5, 0, **kw),
        "retrieve_topn": lambda **kw: loop.retrieve_topn(m, 1, 0.5, 0, 1, **kw),
        "retrieve_global": lambda **kw: loop.retrieve_global(
            m, torch.full((256,), 0.4), 0.5, **kw),
        "verify": lambda **kw: loop.verify(m, 1, 0, None, lc, **kw),
        "verify_features": lambda **kw: loop.verify_features(
            m, feats.desc, feats.has_point, feats.points, 0, None, 0.1, 3, **kw),
        "retrieve_and_verify": lambda **kw: loop.retrieve_and_verify(
            m, 1, None, lc, intr, -1, 0, **kw),
        "close": lambda **kw: loop.close(
            m, 1, 0, torch.eye(4), PoseGraphConfig(iters=1), **kw),
        "track_and_associate": lambda **kw: slam.track_and_associate(
            feats, feats, m, torch.eye(4), torch.eye(4), None, False, 1, intr,
            None, cfg, **kw),
        "relocalize": lambda **kw: slam.relocalize(m, feats, None, cfg, **kw),
        "keyframe_update": lambda **kw: slam.keyframe_update(
            m, feats, torch.eye(4), 2, torch.zeros(k, dtype=torch.int32), none,
            intr, cfg.replace(loop=lc), None, -1, 0, **kw),
        "compact_if_full": lambda **kw: slam.compact_if_full(
            m, cfg, 0, 0, 4, **kw),
        "Slam": lambda **kw: slam.Slam(cfg, intr, **kw),
        "init_scan_state": lambda **kw: slam_scan.init_scan_state(
            g, g, intr, cfg, **kw),
        "ChunkedSlam": lambda **kw: slam_scan.ChunkedSlam(cfg, intr, **kw),
        "generate_lap_sequence": lambda **kw: generate_lap_sequence(
            2, (48, 64), lap_frames=8, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--synthetic", "2"])


def test_patch_kernel_source_and_wrapper_contract():
    """K4 is CUDA C++ with a plain C interface, built at first use and never
    at import; each of its two entries (levels, canvas) counts its launches
    in one place, leaves the CPU to the plain version and takes no other
    device; the front-end calls the levels entry and packs no canvas."""
    from jetracer_orbslam2_torch.ops import fused_patches

    path = cuda_build.library_path("patch_gather")
    assert re.fullmatch(r"patch_gather-[0-9a-f]{16}\.so", path.name)
    assert "patch_gather" not in cuda_build.build_info or torch.cuda.is_available()
    src = (PORT / "csrc" / "patch_gather.cu").read_text()
    assert 'extern "C" int patch_gather_launch(' in src
    assert 'extern "C" int patch_levels_launch(' in src
    for banned in ("torch/extension.h", "#include <ATen", "atomicAdd", "cublas"):
        assert banned not in src, banned
    wrapper = (PORT / "ops" / "fused_patches.py").read_text()
    assert "torch.compile" not in wrapper and "import triton" not in wrapper
    # one count per entry, through step_graph.note_launch
    assert wrapper.count("note_launch(patch_gather)") == 1
    assert wrapper.count("note_launch(extract_patches_fused)") == 1
    assert "except" not in wrapper
    frontend = (PORT / "models" / "frontend.py").read_text()
    assert "fused_patches.extract_patches_fused(" in frontend
    assert "pack_levels" not in frontend and "patch_origins" not in frontend
    assert "patches.extract_patches(" not in frontend.replace(
        "fused_patches.extract_patches_fused(", "")
    # a tensor that lies neither on the CPU nor on a CUDA device is refused:
    # the plain version stands in for the kernel on the CPU only
    canvas = torch.zeros((50, 60), device="meta")
    origins = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_patches.patch_gather(canvas, origins, origins, 37)
    if not torch.cuda.is_available():
        from jetracer_orbslam2_torch.config import FrontendConfig
        from jetracer_orbslam2_torch.models.frontend import frontend_gray_depth
        import numpy as np

        g = np.zeros((48, 64), np.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            frontend_gray_depth(g, g, np.float32([50, 50, 32, 24]),
                                FrontendConfig(height=48, width=64, num_levels=1),
                                device="cuda")


def test_rigid_fit_source_and_wrapper_contract():
    """K5 is CUDA C++ with a plain C interface, built at first use; its sums
    take no float atomics (a replay repeats bit for bit) and no library call;
    the wrapper counts its launch once, leaves the CPU to the SVD route and
    falls back to nothing; `geometry.kabsch` goes through it."""
    from jetracer_orbslam2_torch.ops import fused_rigid

    path = cuda_build.library_path("rigid_fit")
    assert re.fullmatch(r"rigid_fit-[0-9a-f]{16}\.so", path.name)
    src = (PORT / "csrc" / "rigid_fit.cu").read_text()
    assert 'extern "C" int rigid_fit_launch(' in src
    for banned in ("torch/extension.h", "#include <ATen", "atomicAdd",
                   "cublas", "cusolver"):
        assert banned not in src, banned
    wrapper = (PORT / "ops" / "fused_rigid.py").read_text()
    assert "torch.compile" not in wrapper and "import triton" not in wrapper
    assert wrapper.count("note_launch(rigid_fit)") == 1
    assert "except" not in wrapper
    geometry = (PORT / "ops" / "geometry.py").read_text()
    assert "fused_rigid.rigid_fit(" in geometry
    assert "linalg.svd" not in geometry
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_rigid.rigid_fit(meta, meta)


def test_kernel_library_is_keyed_by_source_hash():
    path = cuda_build.library_path("fast_nms")
    assert path.parent == PORT / "_build"
    assert re.fullmatch(r"fast_nms-[0-9a-f]{16}\.so", path.name)
    src = (PORT / "csrc" / "fast_nms.cu").read_text()
    assert "--use_fast_math" not in " ".join(cuda_build.NVCC_FLAGS)
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
    assert 'extern "C" int fast_nms_pyramid_launch' in src
    ignore = (ROOT / ".gitignore").read_text().split()
    assert "jetracer_orbslam2_torch/_build/" in ignore


def test_profile_script_counts_only_host_waits():
    """Switching PyTorch's sync-debug mode on warns once about the mode
    itself; only the warning of a synchronizing operation is a host wait."""
    import importlib.util

    path = ROOT / "scripts" / "profile_torch_odometry.py"
    assert not _FORBIDDEN.search(path.read_text())
    spec = importlib.util.spec_from_file_location("profile_torch_odometry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.is_host_wait_warning(UserWarning(
        "called a synchronizing CUDA operation (Triggered internally at "
        "CUDAFunctions.cpp:162.)"))
    assert not mod.is_host_wait_warning(UserWarning(
        "Synchronization debug mode is a prototype feature and does not yet "
        "detect all synchronizing operations"))
