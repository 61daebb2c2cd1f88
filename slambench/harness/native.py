"""The program's hand-written kernels, built before anything runs."""

from __future__ import annotations

import time


def build() -> float:
    """Compile every kernel source of the program that the checkout does
    not hold built yet, all at once, with the program's own build code (into
    its `_build/` inside the checkout); returns the seconds the compiler
    took, 0 when every library was already built."""
    from jetracer_orbslam2_torch.utils import cuda_build

    names = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    cuda_build.build_libraries(names)
    if all(cuda_build.build_info[n]["seconds"] == 0.0 for n in names):
        return 0.0
    return time.perf_counter() - t0
