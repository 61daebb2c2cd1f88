"""Build and load the port's hand-written CUDA kernels.

Each kernel source is one `csrc/<name>.cu` with a plain C interface.  At first use it
is compiled by `nvcc` for sm_90a into `jetracer_orbslam2_torch/_build/`
(git-ignored) and loaded with `ctypes`; the library's file name carries a hash
of the source and the flags, so an edited source rebuilds and an unchanged one
is reused.  Nothing here runs at import time, and nothing falls back: a
missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when reused), "log": compiler output}
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    cand = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand.append(os.path.join(root, "bin", "nvcc"))
    for c in cand:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of jetracer_orbslam2_torch are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_libraries(names) -> None:
    """Compile every `csrc/<name>.cu` of `names` that is not built yet: one
    `nvcc` process per source, all started together, so several kernels cost
    the time of the slowest.  Raises if any build fails."""
    started = []
    for name in names:
        out = library_path(name)
        if name in build_info or out.exists():
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = CSRC_DIR / f"{name}.cu"
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((name, src, tmp, out, proc, time.perf_counter()))
    failures = []
    for name, src, tmp, out, proc, t0 in started:
        log = proc.communicate()[0].strip()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(
                f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)      # atomic: concurrent processes agree
    if failures:
        raise RuntimeError("\n".join(failures))


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cu`; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        build_libraries([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
