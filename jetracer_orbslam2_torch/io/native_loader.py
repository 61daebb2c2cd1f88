"""ctypes bindings of the native C++ PNG decoder and prefetching frame loader.

Counterpart of `jetracer_orbslam2_tpu/io/native_loader.py`.  The library is
compiled from the repo's `native/png_decode.cpp` and `native/frame_loader.cpp`
by `g++` (`-O3 -fPIC -std=c++17 -shared -lz -lpthread`) into
`jetracer_orbslam2_torch/_build/` at first use, never at import.  Its file
name carries a digest of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.  When the build fails (no compiler, no zlib)
`available()` is False and `io/datasets.py` decodes with PIL instead;
`build_error()` says why.  `JETRACER_DISABLE_NATIVE=1` forces the PIL path.
ctypes releases the GIL during native calls, so decode threads overlap
Python work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("png_decode.cpp", "frame_loader.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lz", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_build_error: Optional[str] = None
# decode threads (runtime.FramePipeline) reach _load() together: the first
# builds and loads, the others wait for it rather than fall back to PIL
_load_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"jetracer_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.  Raises
    RuntimeError when the sources, `g++` or zlib are missing."""
    missing = [n for n in SOURCES if not (NATIVE_DIR / n).is_file()]
    if missing:
        raise RuntimeError(f"native sources not found in {NATIVE_DIR}: {missing}")
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for the native PNG decoder")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, *(str(NATIVE_DIR / n) for n in SOURCES),
         "-o", str(tmp), *LINK_FLAGS],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on the native decoder (exit "
                           f"{proc.returncode}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)          # atomic: concurrent processes agree
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i, p = ctypes.c_int, ctypes.POINTER
    lib.png_probe.restype = i
    lib.png_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [p(i)] * 4
    lib.png_decode.restype = i
    lib.png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, p(ctypes.c_uint8), ctypes.c_size_t]
    lib.loader_open.restype = ctypes.c_void_p
    lib.loader_open.argtypes = [ctypes.c_char_p, i, i]
    lib.loader_count.restype = i
    lib.loader_count.argtypes = [ctypes.c_void_p]
    lib.loader_next_info.restype = i
    lib.loader_next_info.argtypes = [ctypes.c_void_p] + [p(i)] * 5
    lib.loader_take.restype = i
    lib.loader_take.argtypes = [
        ctypes.c_void_p, p(ctypes.c_uint8), ctypes.c_size_t]
    lib.loader_skip.restype = i
    lib.loader_skip.argtypes = [ctypes.c_void_p]
    lib.loader_close.restype = None
    lib.loader_close.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build (once per process) and load the library; None if that failed."""
    global _lib, _lib_tried, _build_error
    with _load_lock:
        if not _lib_tried:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as e:
                _build_error = str(e)
            _lib_tried = True
    return _lib


def available() -> bool:
    """True when the native library is built and loadable and not disabled
    (JETRACER_DISABLE_NATIVE=1 forces the PIL path)."""
    if os.environ.get("JETRACER_DISABLE_NATIVE"):
        return False
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    return _build_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native PNG decoder unavailable: {_build_error}")
    return lib


def _array(h, w, ch, bd) -> np.ndarray:
    dtype = np.uint16 if bd.value == 16 else np.uint8
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
    return np.empty(shape, dtype)


def decode_png(data: bytes) -> np.ndarray:
    """Decode a PNG byte string -> (H, W) or (H, W, C) uint8/uint16 array."""
    lib = _require()
    w, h, ch, bd = (ctypes.c_int() for _ in range(4))
    rc = lib.png_probe(data, len(data), ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(ch), ctypes.byref(bd))
    if rc != 0:
        raise ValueError(f"png_probe failed: {rc}")
    out = _array(h, w, ch, bd)
    rc = lib.png_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    if rc != 0:
        raise ValueError(f"png_decode failed: {rc}")
    return out


def decode_png_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


class NativeFrameLoader:
    """In-order prefetching iterator over a list of PNG paths.

    Yields (index, array) with decoding running ahead on C++ threads; files
    that fail to decode are skipped and counted in `num_errors`.
    """

    def __init__(self, paths: list[str], threads: int = 4,
                 capacity: int = 8):
        self._lib = _require()
        self._h = self._lib.loader_open("\n".join(paths).encode(), threads,
                                        capacity)
        if not self._h:
            raise RuntimeError("loader_open failed")
        self.num_errors = 0

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        lib = self._lib
        idx, w, h, ch, bd = (ctypes.c_int() for _ in range(5))
        while True:
            rc = lib.loader_next_info(
                self._h, ctypes.byref(idx), ctypes.byref(w),
                ctypes.byref(h), ctypes.byref(ch), ctypes.byref(bd))
            if rc in (1, 2):
                return
            if rc < 0:
                self.num_errors += 1
                lib.loader_skip(self._h)
                continue
            out = _array(h, w, ch, bd)
            rc = lib.loader_take(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.nbytes)
            if rc != 0:
                raise RuntimeError(f"loader_take failed: {rc}")
            yield int(idx.value), out

    def close(self):
        if self._h:
            self._lib.loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
