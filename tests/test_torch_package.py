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
    assert len(files) > 20
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
    assert int(out.stdout.split()[-1]) >= 20


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
