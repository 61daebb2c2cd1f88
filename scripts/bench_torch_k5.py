#!/usr/bin/env python3
"""K5 (the rigid-fit kernel) of this tree against a parent checkout's, on
one card, in one process, in turns.

    python3 scripts/bench_torch_k5.py --parent DIR

DIR holds the parent commit unpacked (e.g. `git archive <commit> | tar -x
-C DIR`, into a git-ignored directory).  The parent's
`jetracer_orbslam2_torch/csrc/rigid_fit.cu` must be the one-sided-Jacobi
kernel of the port's first K5 (one block of 256 threads a problem, two
passes, `block_sum`, `jacobi_svd` with fixed sweeps): a harness includes it
unchanged and adds two kernels, its two-pass reduction alone (writing H and
the centroids) and its factorisation alone (one thread, H read from device
memory).  This tree's kernel is split the same way by `chip_smoke.py`'s
`K5_SPLIT_SOURCE`.  At B 1 and 8 problems of 1,024 pairs (`chip_smoke.py`'s
`_rigid_problems`): device time a launch (a replayed CUDA graph of 20
launches, median of 20) of the parent's fit and this tree's, in turns
(parent, this, this, parent), each one's split, and the largest difference
of their transforms.  Prints the card's name and power limit first and a
JSON line last; exits non-zero without a card or when a build fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PARENT_SPLIT_SOURCE = r"""
#include "rigid_fit.cu"

namespace {

__global__ void __launch_bounds__(THREADS)
parent_reduce_only(const float* __restrict__ src, const float* __restrict__ dst,
                   const float* __restrict__ weights, double* __restrict__ out,
                   int n) {
    __shared__ double part[9 * WARPS];
    __shared__ double total[9];
    __shared__ double part2[9 * WARPS];
    __shared__ double total2[9];
    const long long b = blockIdx.x;
    const float* s = src + b * n * 3;
    const float* d = dst + b * n * 3;
    const float* w = weights ? weights + b * n : nullptr;
    double m[7] = {0, 0, 0, 0, 0, 0, 0};
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const double wi = w ? (double)w[i] : 1.0;
        m[0] += wi;
        for (int r = 0; r < 3; ++r) {
            m[1 + r] += wi * (double)s[3 * i + r];
            m[4 + r] += wi * (double)d[3 * i + r];
        }
    }
    block_sum<7>(m, part, total);
    const double wsum = fmax(m[0], 1e-9);
    double mu_s[3], mu_d[3];
    for (int r = 0; r < 3; ++r) {
        mu_s[r] = m[1 + r] / wsum;
        mu_d[r] = m[4 + r] / wsum;
    }
    double h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const double wi = w ? (double)w[i] : 1.0;
        double sc[3], dc[3];
        for (int r = 0; r < 3; ++r) {
            sc[r] = wi * ((double)s[3 * i + r] - mu_s[r]);
            dc[r] = (double)d[3 * i + r] - mu_d[r];
        }
        for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c) h[3 * r + c] += sc[r] * dc[c];
    }
    block_sum<9>(h, part2, total2);
    if (threadIdx.x != 0) return;
    double* o = out + b * 16;
    for (int k = 0; k < 9; ++k) o[k] = h[k];
    for (int r = 0; r < 3; ++r) {
        o[9 + r] = mu_s[r];
        o[12 + r] = mu_d[r];
    }
}

__global__ void __launch_bounds__(THREADS)
parent_factor_only(const double* __restrict__ hm, float* __restrict__ out) {
    const long long b = blockIdx.x;
    if (threadIdx.x != 0) return;
    const double* p = hm + b * 16;
    double h[9], mu_s[3], mu_d[3];
    for (int k = 0; k < 9; ++k) h[k] = p[k];
    for (int r = 0; r < 3; ++r) {
        mu_s[r] = p[9 + r];
        mu_d[r] = p[12 + r];
    }
    double a[3][3], v[3][3], u[3][3], sigma[3];
    for (int c = 0; c < 3; ++c)
        for (int r = 0; r < 3; ++r) a[c][r] = h[3 * r + c];
    jacobi_svd(a, v, sigma);
    left_vectors(a, sigma, u);
    double vc[3];
    cross3(v[0], v[1], vc);
    const double flip = dot3(vc, v[2]) >= 0.0 ? 1.0 : -1.0;
    float* o = out + b * 16;
    for (int i = 0; i < 3; ++i) {
        double R[3];
        for (int j = 0; j < 3; ++j)
            R[j] = v[0][i] * u[0][j] + v[1][i] * u[1][j] + flip * v[2][i] * u[2][j];
        const double t = mu_d[i] - (R[0] * mu_s[0] + R[1] * mu_s[1] + R[2] * mu_s[2]);
        for (int j = 0; j < 3; ++j) o[4 * i + j] = (float)R[j];
        o[4 * i + 3] = (float)t;
    }
    o[12] = 0.0f;
    o[13] = 0.0f;
    o[14] = 0.0f;
    o[15] = 1.0f;
}

}  // namespace

extern "C" int parent_reduce_launch(const float* src, const float* dst,
                                    const float* w, double* out, int batch,
                                    int n, void* stream) {
    parent_reduce_only<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        src, dst, w, out, n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int parent_factor_launch(const double* hm, float* out, int batch,
                                    void* stream) {
    parent_factor_only<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        hm, out);
    return static_cast<int>(cudaGetLastError());
}
"""


def _parent_library(parent: Path):
    """The parent's K5 and its split kernels, built into this tree's
    git-ignored _build/."""
    from jetracer_orbslam2_torch.utils import cuda_build

    csrc = parent / "jetracer_orbslam2_torch" / "csrc"
    if not (csrc / "rigid_fit.cu").is_file():
        raise SystemExit(f"FAIL: no {csrc / 'rigid_fit.cu'}")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = cuda_build.BUILD_DIR / "k5_parent_split.cu"
    source.write_text(PARENT_SPLIT_SOURCE)
    lib_path = cuda_build.BUILD_DIR / "k5_parent_split.so"
    out = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                          str(csrc), "-o", str(lib_path), str(source)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"FAIL: nvcc on the parent's K5:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fit, red, fac = (lib.rigid_fit_launch, lib.parent_reduce_launch,
                     lib.parent_factor_launch)
    fit.argtypes = red.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    fac.argtypes = [ptr, ptr, i32, ptr]
    fit.restype = red.restype = fac.restype = i32
    return fit, red, fac


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the parent commit unpacked")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_k5: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jetracer_orbslam2_torch.ops import fused_rigid
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    cs.say(cs.card_line())
    set_exact_f32()
    fit, red, fac = _parent_library(args.parent.resolve())
    dev = torch.device("cuda:0")
    n = cs.K5_POINTS

    def check(err: int) -> None:
        if err != 0:
            raise SystemExit(f"FAIL: a parent kernel did not launch: cudaError {err}")

    report = {"floor_us": cs.launch_floor_ms() * 1e3}
    with torch.no_grad():
        for b in (1, 8):
            src, dst, w = cs._rigid_problems(b, n, 0, dev)
            T = torch.empty((b, 4, 4), dtype=torch.float32, device=dev)
            hm = torch.empty((b, 16), dtype=torch.float64, device=dev)
            stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
            parent = lambda: check(fit(src.data_ptr(), dst.data_ptr(),  # noqa: E731
                                       w.data_ptr(), T.data_ptr(), b, n, stream()))
            this = lambda: fused_rigid.rigid_fit(src, dst, w)  # noqa: E731
            parent()
            diff = float((T - this()).abs().max())
            row = {"parent_us": [], "this_us": [], "max_diff": diff}
            for key, fn in (("parent_us", parent), ("this_us", this),
                            ("this_us", this), ("parent_us", parent)):
                row[key].append(cs.time_launches(fn, reps=20, batch=20) * 1e3)
            reduce_only = lambda: check(red(  # noqa: E731
                src.data_ptr(), dst.data_ptr(), w.data_ptr(), hm.data_ptr(), b, n,
                stream()))
            factor_only = lambda: check(fac(  # noqa: E731
                hm.data_ptr(), T.data_ptr(), b, stream()))
            reduce_only()
            factor_only()
            row["parent_split"] = {
                "reduction_us": cs.time_launches(reduce_only, reps=20, batch=20) * 1e3,
                "factorisation_us": cs.time_launches(factor_only, reps=20,
                                                     batch=20) * 1e3}
            row["this_split"] = cs._k5_split(src, dst, w)
            report[f"B {b}"] = row
            cs.say(f"B {b}, N {n}: " + json.dumps(row))
    cs.say(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
