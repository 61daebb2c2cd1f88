"""Package hygiene of the PyTorch port: it imports no JAX and nothing of the
JAX package, chooses the card by default, and refuses what is not ported."""

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
                "ops/fused_ba.py", "parallel/bench_ba.py", "convert.py"):
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
    from jetracer_orbslam2_torch.parallel import bench_ba

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
    assert wrapper.count(".launches += 1") == 2


def test_set_exact_f32():
    torch.backends.cudnn.allow_tf32 = True
    set_exact_f32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("argv", [
    ["--synthetic", "4", "--mode", "slam"],
    ["--synthetic", "4"],                        # --mode defaults to slam
    ["--dataset", "/nonexistent", "--mode", "odometry"],
    ["--mode", "odometry"],
])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    assert trun.main(argv + ["--device", "cpu"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "not ported" in captured.err or "need --synthetic" in captured.err


def test_kernel_library_is_keyed_by_source_hash():
    path = cuda_build.library_path("fast_nms")
    assert path.parent == PORT / "_build"
    assert re.fullmatch(r"fast_nms-[0-9a-f]{16}\.so", path.name)
    src = (PORT / "csrc" / "fast_nms.cu").read_text()
    assert "--use_fast_math" not in " ".join(cuda_build.NVCC_FLAGS)
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
    assert 'extern "C" int fast_nms_launch' in src
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
