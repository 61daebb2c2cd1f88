"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, and nothing of the program in the plain references (top-level
module names compared whole: the port's name begins with the JAX
package's)."""

import ast
import subprocess
import sys

import pytest

from slambench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "jetracer_orbslam2_tpu"}
FILES = sorted(spec.BENCH_DIR.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(spec.BENCH_DIR))
                                             for p in FILES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_references_import_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").rglob("*.py"):
        assert "jetracer_orbslam2_torch" not in top_level_imports(path), path


def test_only_the_entries_and_the_build_import_the_program():
    for path in FILES:
        if "jetracer_orbslam2_torch" in top_level_imports(path):
            assert (path.parent.name in ("entries", "tests")
                    or path.name == "native.py"), path


def test_the_port_is_not_taken_for_the_jax_package():
    sys.path.insert(0, str(spec.BENCH_DIR))
    try:
        import run
    finally:
        sys.path.remove(str(spec.BENCH_DIR))
    names = ["jetracer_orbslam2_torch", "jetracer_orbslam2_torch.models",
             "jaxtyping", "flaxen", "numpy"]
    assert run.forbidden_modules(names) == []
    assert run.forbidden_modules(names + ["jax.numpy", "jetracer_orbslam2_tpu"]) \
        == ["jax", "jetracer_orbslam2_tpu"]


def test_a_run_without_a_device_prints_no_result():
    """On a machine without a CUDA device the command fails and prints
    nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         "tum-rgbd.desk-odometry", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.ROOT)
    assert out.returncode == 3
    assert out.stdout == ""
    assert "CUDA" in out.stderr
