#!/usr/bin/env python3
"""K6 (the reprojection polish kernel) of this tree against a parent
checkout's, on one card, in one process, in turns; and this tree's kernel
split into its parts.

    python3 scripts/bench_torch_k6.py --parent DIR

DIR holds the parent commit unpacked (e.g. `git archive <commit> | tar -x
-C DIR`, into a git-ignored directory).  Its
`jetracer_orbslam2_torch/csrc/pose_polish.cu` must have the first K6's C
interface (`pose_polish_launch(T0, X, uv, zd, w, intr, out, singular,
batch, k, iters, huber, stream)`); it is built unchanged into this tree's
git-ignored `_build/`.  At B 1 and 8 problems of 1,024 points and at B 1 of
8,192 (`chip_smoke.py`'s `_polish_problems`, the synthetic camera's
intrinsics), 5 steps: device time a launch (a replayed CUDA graph of 20
launches, median of 20) of the parent's kernel and this tree's, in turns
(parent, this, this, parent), each one's split by steps (0, 1, 5), and the
largest difference of their transforms.  Then this tree's step split into
its parts by a harness that includes `csrc/pose_polish.cu`, 5 steps in one
launch each, at the cluster size the wrapper takes for K 1,024: the pass
over the points and the warp reduce-scatter alone, the exchange between the
cluster's blocks alone (the st.async stores into every block, the wait on
the block's mbarrier, the sum of the partials and their broadcast), and one
warp's 6 x 6 solve and se3_exp alone.  Prints the card's name and power limit first and a JSON
line last; exits non-zero without a card or when a build fails.
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

# this tree's step in its parts: each kernel runs `iters` steps of one part
# of pose_polish_kernel through the same device functions, with a
# dependence from each step to the next (a product with 0.0, which no IEEE
# compiler removes)
SPLIT_SOURCE = r"""
#include "pose_polish.cu"

namespace {

// the pass over the held points and the warp reduce-scatter
__global__ void __launch_bounds__(THREADS)
k6_points_only(const float* __restrict__ X, const float* __restrict__ uv,
               const float* __restrict__ zd, const float* __restrict__ w,
               const float* __restrict__ intr, float* __restrict__ out, int k,
               int iters) {
    const int g = blockIdx.x * THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const Camera cam = {intr[0], intr[1], intr[2], intr[3]};
    float T[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
    // a point a thread, as pose_polish_launch's cluster gives them at
    // K <= ctas x THREADS
    Point held = load_point(X, uv, zd, w, min(g, k - 1), cam.fx);
    for (int it = 0; it < iters; ++it) {
        float s[NSLOT];
#pragma unroll
        for (int m = 0; m < NSLOT; ++m) s[m] = 0.0f;
        if (g < k) accumulate(s, held, T, cam, 2.0f);
        reduce_scatter(s, lane);
        T[3] += s[0] * 0.0f;
    }
    if (threadIdx.x == 0) out[blockIdx.x] = T[3];
}

// the exchange: every warp's partials into every block of the cluster,
// then every warp's fixed-order sum and broadcast
__global__ void __launch_bounds__(THREADS)
k6_exchange_only(float* __restrict__ out, int iters, int ctas) {
    __shared__ double part[2][MAX_CTAS * WARPS][NSLOT];
    __shared__ uint64_t bar[2];
    const int rank = static_cast<int>(cg::this_cluster().block_rank());
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    double carry = lane;
    if (iters > 0) exchange_setup(bar);
    for (int it = 0; it < iters; ++it) {
        exchange_expect(bar, it, ctas);
        exchange_send(carry, part, bar, it, rank, ctas, warp, lane);
        const double total = exchange_total(part, bar, it, ctas, lane);
        double sums[NSUM];
#pragma unroll
        for (int m = 0; m < NSUM; ++m) sums[m] = __shfl_sync(FULL, total, m);
        carry = lane + (sums[0] + sums[NSUM - 1]) * 0.0;
    }
    if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(carry);
}

// one warp's 6 x 6 solve and se3_exp on sums read once
__global__ void __launch_bounds__(32)
k6_solve_only(const double* __restrict__ sums_in, float* __restrict__ out, int iters) {
    double sums[NSUM];
#pragma unroll
    for (int m = 0; m < NSUM; ++m) sums[m] = sums_in[m];
    float T[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
    for (int it = 0; it < iters; ++it) {
        double dx[6];
        block_solve(sums, dx);
        float xi[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) xi[m] = static_cast<float>(dx[m]);
        exp_update(xi, T);
        sums[NH] += static_cast<double>(T[3]) * 0.0;
    }
    if (threadIdx.x == 0)
        for (int m = 0; m < 16; ++m) out[m] = T[m];
}

}  // namespace

extern "C" int k6_points_launch(const float* X, const float* uv, const float* zd,
                                const float* w, const float* intr, float* out, int k,
                                int iters, int ctas, void* stream) {
    k6_points_only<<<ctas, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        X, uv, zd, w, intr, out, k, iters);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int k6_exchange_launch(float* out, int iters, int ctas, void* stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(THREADS);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, k6_exchange_only, out, iters, ctas));
}

extern "C" int k6_solve_launch(const double* sums, float* out, int iters, void* stream) {
    k6_solve_only<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(sums, out, iters);
    return static_cast<int>(cudaGetLastError());
}
"""


def _build(name: str, source: Path, include: Path) -> ctypes.CDLL:
    from jetracer_orbslam2_torch.utils import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = cuda_build.BUILD_DIR / f"{name}.so"
    out = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                          str(include), "-o", str(lib_path), str(source)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"FAIL: nvcc on {source}:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(lib_path))


def _parent_launcher(parent: Path):
    """The parent's pose_polish_launch, built unchanged."""
    csrc = parent / "jetracer_orbslam2_torch" / "csrc"
    if not (csrc / "pose_polish.cu").is_file():
        raise SystemExit(f"FAIL: no {csrc / 'pose_polish.cu'}")
    fn = _build("k6_parent", csrc / "pose_polish.cu", csrc).pose_polish_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32, i32, i32, ctypes.c_float, ptr]
    fn.restype = i32
    return fn


def _split_library():
    """This tree's split kernels, built from SPLIT_SOURCE."""
    from jetracer_orbslam2_torch.utils import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = cuda_build.BUILD_DIR / "k6_split.cu"
    source.write_text(SPLIT_SOURCE)
    lib = _build("k6_split", source, cuda_build.CSRC_DIR)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k6_points_launch.argtypes = [ptr] * 6 + [i32, i32, i32, ptr]
    lib.k6_exchange_launch.argtypes = [ptr, i32, i32, ptr]
    lib.k6_solve_launch.argtypes = [ptr, ptr, i32, ptr]
    for fn in (lib.k6_points_launch, lib.k6_exchange_launch, lib.k6_solve_launch):
        fn.restype = i32
    return lib


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the parent commit unpacked")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_k6: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jetracer_orbslam2_torch.io.synthetic import _intrinsics
    from jetracer_orbslam2_torch.ops import fused_polish
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    cs.say(cs.card_line())
    set_exact_f32()
    parent = _parent_launcher(args.parent.resolve())
    split = _split_library()
    dev = torch.device("cuda:0")
    intr = _intrinsics((480, 640), dev).float().contiguous()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check(err: int) -> None:
        if err != 0:
            raise SystemExit(f"FAIL: a kernel did not launch: cudaError {err}")

    def us(fn) -> float:
        return cs.time_launches(fn, reps=20, batch=20) * 1e3

    report = {"floor_us": cs.launch_floor_ms() * 1e3}
    with torch.no_grad():
        for b, k in ((1, 1024), (8, 1024), (1, 8192)):
            T0, X, uv, z, w = cs._polish_problems(b, k, 0, intr, dev)
            out = torch.empty_like(T0)

            def run_parent(iters=cs.K6_ITERS):
                check(parent(*(x.data_ptr() for x in (T0, X, uv, z, w, intr, out)),
                             None, b, k, iters, cs.K6_HUBER, stream()))

            def run_this(iters=cs.K6_ITERS):
                return fused_polish.pose_polish(T0, X, uv, z, w, intr, iters,
                                                cs.K6_HUBER)

            run_parent()
            diff = float((out - run_this()).abs().max())
            row = {"parent_us": [], "this_us": [], "max_diff": diff}
            for key, fn in (("parent_us", run_parent), ("this_us", run_this),
                            ("this_us", run_this), ("parent_us", run_parent)):
                row[key].append(us(fn))
            row["parent_steps_us"] = {i: us(lambda: run_parent(i)) for i in (0, 1, 5)}
            row["this_steps_us"] = {i: us(lambda: run_this(i)) for i in (0, 1, 5)}
            report[f"B {b}, K {k}"] = row
            cs.say(f"B {b}, K {k}: " + json.dumps(row))

        # this tree's step in parts at B 1, K 1,024
        k = cs.K6_POINTS
        T0, X, uv, z, w = cs._polish_problems(1, k, 0, intr, dev)
        ctas = 1                             # csrc/pose_polish.cu's ctas_for
        while ctas < 8 and ctas * 128 < k:
            ctas *= 2
        sink = torch.empty(16, dtype=torch.float32, device=dev)
        sums = torch.rand(27, dtype=torch.float64, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        sums[[0, 6, 11, 15, 18, 20]] += 10.0         # a positive definite H
        parts = {}
        for iters in (0, cs.K6_ITERS):
            parts[iters] = {
                "points_and_fold_us": us(lambda: check(split.k6_points_launch(
                    *(x.data_ptr() for x in (X, uv, z, w, intr, sink)), k, iters,
                    ctas, stream()))),
                "exchange_us": us(lambda: check(split.k6_exchange_launch(
                    sink.data_ptr(), iters, ctas, stream()))),
                "solve_and_exp_us": us(lambda: check(split.k6_solve_launch(
                    sums.data_ptr(), sink.data_ptr(), iters, stream()))),
            }
        report["this_split"] = {"ctas": ctas, "parts": parts}
        cs.say(f"this tree's step in parts at B 1, K {k}, {ctas} block(s): "
               + json.dumps(parts))
    cs.say(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
