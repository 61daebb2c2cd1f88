#!/usr/bin/env python3
"""K7 (RANSAC's hypotheses, scores and winner) of this tree against a parent
checkout's, on one card, in one process, in turns; and this tree's kernel's
serial chain split into its links.

    python3 scripts/bench_torch_k7.py --parent DIR

DIR holds the parent commit unpacked (e.g. `git archive <commit> | tar -x
-C DIR`, into a git-ignored directory).  Its
`jetracer_orbslam2_torch/csrc/ransac_hyp.cu` must have K7's C interface
(`ransac_hyp_launch(src, dst, keep, idx, tz, best, score, w1, batch, k, h,
stream)` and `ransac_hyp_setup()`); it is built unchanged, with the
parent's `csrc/cluster.cuh`, into this tree's git-ignored `_build/`.

At B 1, H 256 and 512; B 8, H 256; B 3, H 512 (all K 1,024); B 1, H 256,
K 8,192 (the streamed path), on `chip_smoke.py`'s `_ransac_problems` with
phase 24's seeds, and on the odometry run's first 40 RANSAC problems as one
batch: best, score and w1 of the two kernels must be `torch.equal`; then
device time a launch (a replayed CUDA graph of 20 launches, median of 20)
of the parent's kernel and this tree's, in turns (parent, this, this,
parent).

Then this tree's kernel's chain in its links, through a harness
(SPLIT_SOURCE) that includes its `ransac_hyp.cu`, at the launch shape the
wrapper gives B 1, H 256, K 1,024, each link a launch of its own:
  (a) an empty kernel at the same cluster size, threads and shared memory;
  (b) the gather of the drawn points and the hypotheses' solve;
  (c) the staging of the points into shared memory alone;
  (d) the tests alone, from hypotheses and points already in shared memory
      (written there by the block's threads: a few stores a thread);
  (e) the block's reduction, the exchange between the cluster's blocks and
      the w1 pass (the counts and points written there as in (d); with the
      exchange's set-up, which the kernel hides behind its Newton steps).
Every link's time includes the launch, (a).  Then the kernel's own body
(`select_block`) with clock64 read at its marks (loaded, solved, tested,
the block's best, the exchange and w1 pass): cycles a link, summed over
the rounds, of the slowest block.  Prints the card's name and
power limit first and a JSON line last; exits non-zero without a card, when
a build fails or when the two kernels' outputs differ.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the shapes timed: (label, B, K, H, phase 24's seed)
SHAPES = (
    ("B 1, H 256, K 1,024", 1, 1024, 256, 80),
    ("B 1, H 512, K 1,024", 1, 1024, 512, 81),
    ("B 8, H 256, K 1,024", 8, 1024, 256, 88),
    ("B 3, H 512, K 1,024", 3, 1024, 512, 89),
    ("B 1, H 256, K 8,192 (streamed)", 1, 8192, 256, 82),
)

# The launcher every split kernel goes through: B problems on clusters of
# `ctas` blocks of `threads`, `smem` bytes of dynamic shared memory.
SPLIT_COMMON = r"""
template <typename... Params, typename... Args>
cudaError_t k7_launch_as(void (*kernel)(Params...), int batch, int ctas, int threads,
                         int smem, cudaStream_t s, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && ctas > 8)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(batch * ctas));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the synthetic points and hypotheses of (d) and (e): R = I, t = (1e-3 (j % 64),
// 0, 0), dst = src + (1e-2 (i % 7) + 5e-4, 0, 0), a 3 cm gate: every error an
// odd multiple of 0.5 mm, none within 1e-6 of its gate, about half pass
__device__ __forceinline__ void k7_point(int i, float (&s)[3], float (&d)[3]) {
    s[0] = 1e-3f * i, s[1] = 1.0f, s[2] = 2.0f;
    d[0] = 1e-3f * i + 1e-2f * (i % 7) + 5e-4f, d[1] = 1.0f, d[2] = 2.0f;
}
constexpr float K7_GATE = 0.03f;
__device__ __forceinline__ void k7_fill_point(float* s_src, float* s_dst, float* s_tz,
                                              float* s_keep, int i) {
    float s[3], d[3];
    k7_point(i, s, d);
    for (int c = 0; c < 3; ++c) s_src[3 * i + c] = s[c], s_dst[3 * i + c] = d[c];
    s_tz[i] = K7_GATE;
    s_keep[i] = 1.0f;
}
__device__ __forceinline__ void k7_fill_hyp(float* T, int j) {
#pragma unroll
    for (int c = 0; c < 12; ++c) T[c] = (c % 5 == 0) ? 1.0f : 0.0f;
    T[3] = 1e-3f * (j % 64);
}
"""

# Outside the harness's namespace: the launch floor at a cluster shape, and
# the clusters of that shape that fit on the card at once.
SPLIT_PROBES = r"""
namespace {
__global__ void k7_probe_empty(float* out) {
    if (out != nullptr && threadIdx.x == 0) out[blockIdx.x] = 0.0f;
}

}  // namespace

// an empty kernel on clusters of `ctas` blocks of `threads` with `smem`
// bytes of dynamic shared memory, B clusters
extern "C" int k7_probe_launch(int batch, int ctas, int threads, int smem, void* stream) {
    float* none = nullptr;
    return static_cast<int>(k7_launch_as(k7_probe_empty, batch, ctas, threads, smem,
                                         static_cast<cudaStream_t>(stream), none));
}

// cudaOccupancyMaxActiveClusters of that shape
extern "C" int k7_probe_clusters(int ctas, int threads, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        k7_probe_empty, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(k7_probe_empty,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(ctas));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, k7_probe_empty, &cfg);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
"""

# The split of this tree's kernel: each link calls the kernel's own stages,
# and the stamped chain is the kernel's own body, select_block.
SPLIT_SOURCE = r"""
#include "ransac_hyp.cu"

namespace {
""" + SPLIT_COMMON + r"""
__global__ void __launch_bounds__(THREADS, 1) k7_empty(float* out) {
    if (out != nullptr && threadIdx.x == 0) out[blockIdx.x] = 0.0f;
}

// this block's problem, its first round's hypotheses [h0, h0 + n)
__device__ __forceinline__ Problem k7_problem(const float* src, const float* dst,
                                              const float* keep, const long long* idx,
                                              const float* tz, int k, int h, int ctas,
                                              int& n, int& h0) {
    const long long b = blockIdx.x / ctas;
    const Problem pb = {src + b * 3 * k, dst + b * 3 * k, keep + b * k, tz + b * k,
                        idx + b * 3 * h, k, h,
                        static_cast<int>(cg::this_cluster().block_rank()), ctas};
    const int per = (h + ctas - 1) / ctas;
    h0 = min(h, pb.rank * per);
    n = min(ROUND, min(h, h0 + per) - h0);
    return pb;
}

// the synthetic points (as staged records) and hypotheses of (d) and (e)
__device__ __forceinline__ void k7_fill(float4* rec, Shared& sm, int k, int n, int h0) {
    for (int i = threadIdx.x; i < k; i += THREADS) {
        float s[3], d[3];
        k7_point(i, s, d);
        const float t2 = mul(K7_GATE, K7_GATE);
        rec[2 * i] = make_float4(s[0], s[1], s[2], d[0]);
        rec[2 * i + 1] = make_float4(d[1], d[2], mul(t2, 0.999999f), mul(t2, 1.000001f));
    }
    if (threadIdx.x < n) {
        float T[12];
        k7_fill_hyp(T, h0 + threadIdx.x);
        for (int a = 0; a < 3; ++a)
            sm.hyp[threadIdx.x][a] = make_float4(T[4 * a], T[4 * a + 1], T[4 * a + 2], T[4 * a + 3]);
    }
}

// (b) the first round's draws, the staging, the gather and the solve
__global__ void __launch_bounds__(THREADS, 1)
k7_solve(const float* src, const float* dst, const float* keep, const long long* idx,
         const float* tz, float* out, int k, int h, int ctas) {
    extern __shared__ float4 rec[];
    __shared__ Shared sm;
    int n, h0;
    const Problem pb = k7_problem(src, dst, keep, idx, tz, k, h, ctas, n, h0);
    const int myidx = drawn(pb, h0, n);
    stage_records(rec, pb);
    __syncthreads();
    if (n > 0) solve_round<true>(sm, rec, pb, myidx, n, false);
    if (out != nullptr && threadIdx.x == 0) out[blockIdx.x] = sm.hyp[0][0].x;
}

// (c) the staging alone
__global__ void __launch_bounds__(THREADS, 1)
k7_stage(const float* src, const float* dst, const float* keep, const long long* idx,
         const float* tz, float* out, int k, int h, int ctas) {
    extern __shared__ float4 rec[];
    int n, h0;
    const Problem pb = k7_problem(src, dst, keep, idx, tz, k, h, ctas, n, h0);
    stage_records(rec, pb);
    __syncthreads();
    if (out != nullptr && threadIdx.x == 0) out[blockIdx.x] = rec[0].x;
}

// (d) the tests alone
__global__ void __launch_bounds__(THREADS, 1)
k7_tests(const float* src, const float* dst, const float* keep, const long long* idx,
         const float* tz, float* out, int k, int h, int ctas) {
    extern __shared__ float4 rec[];
    __shared__ Shared sm;
    int n, h0;
    const Problem pb = k7_problem(src, dst, keep, idx, tz, k, h, ctas, n, h0);
    k7_fill(rec, sm, k, n, h0);
    if (threadIdx.x < ROUND) sm.counts[threadIdx.x] = 0;
    __syncthreads();
    test_round<true>(sm, rec, pb, n);
    if (out != nullptr && threadIdx.x == 0) out[blockIdx.x] = sm.counts[0];
}

// (e) the block's best, the exchange, the winner and the w1 pass
__global__ void __launch_bounds__(THREADS, 1)
k7_tail(const float* src, const float* dst, const float* keep, const long long* idx,
        const float* tz, long long* best, int* score, float* w1, int k, int h, int ctas) {
    extern __shared__ float4 rec[];
    __shared__ Shared sm;
    int n, h0;
    const Problem pb = k7_problem(src, dst, keep, idx, tz, k, h, ctas, n, h0);
    exchange_init(sm, ctas);
    k7_fill(rec, sm, k, n, h0);
    if (threadIdx.x < n) sm.counts[threadIdx.x] = (h0 + threadIdx.x) * 37 % 101;
    __syncthreads();
    unsigned long long best_k = 0;
    float4 best_T[3] = {};
    if ((threadIdx.x >> 5) == 0) round_best(sm, h0, n, best_k, best_T);
    __syncthreads();
    finish<true>(sm, rec, pb, best_k, best_T, blockIdx.x / ctas, best, score, w1);
}

// the clock64 cycles of each of the chain's links (select_block's marks),
// summed over the rounds, in thread 0 of each block
struct ClockMarks {
    long long last, cycles[5];
    __device__ ClockMarks() {
        for (int i = 0; i < 5; ++i) cycles[i] = 0;
        last = clock64();
    }
    __device__ __forceinline__ void operator()(int i) {
        const long long t = clock64();
        cycles[i] += t - last;
        last = t;
    }
};

// the kernel, ransac_hyp_kernel<true>, its links' cycles stored a block
__global__ void __launch_bounds__(THREADS, 1)
k7_stamped(const float* src, const float* dst, const float* keep, const long long* idx,
           const float* tz, long long* best, int* score, float* w1, int k, int h, int ctas,
           long long* stamps) {
    extern __shared__ float4 rec[];
    __shared__ Shared sm;
    ClockMarks mark;
    select_block<true>(sm, rec, src, dst, keep, idx, tz, best, score, w1, k, h, ctas, mark);
    if (threadIdx.x == 0)
        for (int i = 0; i < 5; ++i) stamps[5 * blockIdx.x + i] = mark.cycles[i];
}

}  // namespace

extern "C" int k7_split_launch(char part, const float* src, const float* dst,
                               const float* keep, const long long* idx, const float* tz,
                               long long* best, int* score, float* w1, int batch, int k,
                               int h, void* stream) {
    const int ctas = ctas_for(h);
    const int smem = staged_bytes(k);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* none = nullptr;
    cudaError_t err;
    switch (part) {
    case 'a':   // the real kernel's shared memory a block, all of it dynamic
        err = k7_launch_as(k7_empty, batch, ctas, THREADS,
                           smem + static_cast<int>(sizeof(Shared)), s, none);
        break;
    case 'b':
        err = k7_launch_as(k7_solve, batch, ctas, THREADS, smem, s, src, dst, keep, idx, tz,
                           none, k, h, ctas);
        break;
    case 'c':
        err = k7_launch_as(k7_stage, batch, ctas, THREADS, smem, s, src, dst, keep, idx, tz,
                           none, k, h, ctas);
        break;
    case 'd':
        err = k7_launch_as(k7_tests, batch, ctas, THREADS, smem, s, src, dst, keep, idx, tz,
                           none, k, h, ctas);
        break;
    case 'e':
        err = k7_launch_as(k7_tail, batch, ctas, THREADS, smem, s, src, dst, keep, idx, tz,
                           best, score, w1, k, h, ctas);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}

extern "C" int k7_split_shape(int k, int h, int* out) {
    out[0] = ctas_for(h);
    out[1] = THREADS;
    out[2] = staged_bytes(k);
    return 0;
}

extern "C" int k7_stamped_launch(const float* src, const float* dst, const float* keep,
                                 const long long* idx, const float* tz, long long* best,
                                 int* score, float* w1, int k, int h, long long* stamps,
                                 void* stream) {
    const int ctas = ctas_for(h);
    return static_cast<int>(k7_launch_as(k7_stamped, 1, ctas, THREADS, staged_bytes(k),
                                         static_cast<cudaStream_t>(stream), src, dst, keep,
                                         idx, tz, best, score, w1, k, h, ctas, stamps));
}
""" + SPLIT_PROBES

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
    """The parent's ransac_hyp_launch, built unchanged and set up."""
    csrc = parent / "jetracer_orbslam2_torch" / "csrc"
    if not (csrc / "ransac_hyp.cu").is_file():
        raise SystemExit(f"FAIL: no {csrc / 'ransac_hyp.cu'}")
    lib = _build("k7_parent", csrc / "ransac_hyp.cu", csrc)
    fn = lib.ransac_hyp_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    fn.restype = lib.ransac_hyp_setup.restype = i32
    if lib.ransac_hyp_setup() != 0:
        raise SystemExit("FAIL: the parent's ransac_hyp_setup failed")
    return fn


def _split_library():
    """SPLIT_SOURCE built against this tree's csrc/ and set up."""
    from jetracer_orbslam2_torch.utils import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = cuda_build.BUILD_DIR / "k7_split.cu"
    source.write_text(SPLIT_SOURCE)
    lib = _build("k7_split", source, cuda_build.CSRC_DIR)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k7_split_launch.argtypes = [ctypes.c_char] + [ptr] * 8 + [i32] * 3 + [ptr]
    lib.k7_split_launch.restype = i32
    lib.k7_split_shape.argtypes = [i32, i32, ptr]
    lib.k7_split_shape.restype = i32
    lib.ransac_hyp_setup.restype = i32
    if lib.ransac_hyp_setup() != 0:
        raise SystemExit("FAIL: the split harness's setup failed")
    return lib


def _split(lib, problem, us) -> dict:
    """The links (a)-(e), device us a launch, at this problem's shape."""
    import torch

    src, dst, keep, idx, tz = problem
    b, k, h = src.shape[0], src.shape[1], idx.shape[1]
    best = torch.empty((b,), dtype=torch.int64, device=src.device)
    score = torch.empty((b,), dtype=torch.int32, device=src.device)
    w1 = torch.empty((b, k), dtype=torch.float32, device=src.device)
    shape = (ctypes.c_int * 3)()
    lib.k7_split_shape(k, h, shape)
    links = {}
    for part in "abcde":
        def run(part=part):
            err = lib.k7_split_launch(
                part.encode(), *(x.data_ptr() for x in (src, dst, keep, idx, tz, best,
                                                        score, w1)),
                b, k, h, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"FAIL: split link ({part}) did not launch: "
                                 f"cudaError {err}")
        links[part] = us(run)
    return {"ctas": shape[0], "threads": shape[1], "staged_bytes": shape[2],
            "links_us": links}


def _launch_shapes(lib, us) -> dict:
    """The empty kernel's device us a launch and cudaOccupancyMaxActiveClusters
    at the cluster shapes a design may take: 1-16 blocks of 256-1,024
    threads with 48 KB of shared memory a block, B 1 and 8."""
    import torch

    lib.k7_probe_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.k7_probe_launch.restype = ctypes.c_int
    lib.k7_probe_clusters.argtypes = [ctypes.c_int] * 3
    lib.k7_probe_clusters.restype = ctypes.c_int
    smem = 48 * 1024
    rows = {}
    for ctas, threads in itertools.product((1, 4, 8, 16), (256, 512, 1024)):
        row = {"max_active_clusters": lib.k7_probe_clusters(ctas, threads, smem)}
        for b in (1, 8):
            def run(b=b):
                err = lib.k7_probe_launch(b, ctas, threads, smem,
                                          torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise SystemExit(f"FAIL: the empty kernel at {ctas} x {threads} "
                                     f"did not launch: cudaError {err}")
            row[f"B {b} us"] = us(run)
        rows[f"{ctas} x {threads}"] = row
    return rows


def _stamped(lib, problem) -> dict:
    """The kernel's own chain at this problem (B 1), from its body with
    clock64 marks: cycles a link, the median over 20 launches of the
    largest over the cluster's blocks, with the outputs checked against the
    wrapper's."""
    import statistics

    import torch
    from jetracer_orbslam2_torch.ops import fused_ransac

    src, dst, keep, idx, tz = problem
    k, h = src.shape[1], idx.shape[1]
    best = torch.empty((1,), dtype=torch.int64, device=src.device)
    score = torch.empty((1,), dtype=torch.int32, device=src.device)
    w1 = torch.empty((1, k), dtype=torch.float32, device=src.device)
    stamps = torch.zeros(5 * 16, dtype=torch.int64, device=src.device)
    fn = lib.k7_stamped_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    names = ("loaded", "solved", "tested", "block best", "exchange and w1")
    rows = []
    for _ in range(25):
        stamps.zero_()
        err = fn(*(x.data_ptr() for x in (src, dst, keep, idx, tz, best, score, w1)), k, h,
                 stamps.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"FAIL: the stamped K7 did not launch: cudaError {err}")
        torch.cuda.synchronize()
        rows.append(stamps.view(16, 5).cpu())
    want = fused_ransac.ransac_select(*problem)
    if not (torch.equal(best, want[0]) and torch.equal(score, want[1])
            and torch.equal(w1, want[2])):
        raise SystemExit("FAIL: the stamped K7 differs from the wrapper's")
    used = [r[r.sum(1) != 0] for r in rows[5:]]
    return {name: statistics.median(int(r[:, i].max()) for r in used)
            for i, name in enumerate(names)}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the parent commit unpacked")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_k7: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.ops import fused_ransac
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    cs.say(cs.card_line())
    set_exact_f32()
    parent = _parent_launcher(args.parent.resolve())
    lib = _split_library()
    dev = torch.device("cuda:0")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def us(fn) -> float:
        return cs.time_launches(fn, reps=20, batch=20) * 1e3

    problems = [(label, cs._ransac_problems(b, k, h, seed, dev))
                for label, b, k, h, seed in SHAPES]
    _, cli, source, _ = cs.open_source(cs.K6_CAPTURED_FRAMES, dev)
    frames = list(itertools.islice(source.frames(), cs.K6_CAPTURED_FRAMES))
    fcfg = run._frontend_cfg(cli, source.hw, source.cal)
    real = cs._captured_ransac_problems(frames, source.intr, fcfg, dev)
    problems.append((f"the odometry run's first {cs.K6_CAPTURED_FRAMES} frames' "
                     f"problems (B {real[0].shape[0]}, H {real[3].shape[1]}, K "
                     f"{real[0].shape[1]})", real))

    report = {"floor_us": cs.launch_floor_ms() * 1e3, "shapes": {}}
    with torch.no_grad():
        for n_shape, (label, problem) in enumerate(problems):
            src, dst, keep, idx, tz = problem
            b, k, h = src.shape[0], src.shape[1], idx.shape[1]
            best = torch.empty((b,), dtype=torch.int64, device=dev)
            score = torch.empty((b,), dtype=torch.int32, device=dev)
            w1 = torch.empty((b, k), dtype=torch.float32, device=dev)

            def run_parent():
                err = parent(*(x.data_ptr() for x in (src, dst, keep, idx, tz, best,
                                                      score, w1)), b, k, h, stream())
                if err != 0:
                    raise SystemExit(f"FAIL: the parent's K7 did not launch: "
                                     f"cudaError {err}")

            def run_this():
                return fused_ransac.ransac_select(*problem)

            run_parent()
            got = run_this()
            torch.cuda.synchronize()
            equal = {name: bool(torch.equal(x, y)) for name, x, y in
                     (("best", best, got[0]), ("score", score, got[1]),
                      ("w1", w1, got[2]))}
            cs.say(f"{label}: outputs torch.equal to the parent's: {equal} "
                   f"(scores {got[1].tolist()[:8]})")
            if not all(equal.values()):
                raise SystemExit(f"FAIL: K7 differs from the parent's at {label}")
            row = {"equal": equal}
            if n_shape < len(SHAPES):
                row.update(parent_us=[], this_us=[])
                for key, fn in (("parent_us", run_parent), ("this_us", run_this),
                                ("this_us", run_this), ("parent_us", run_parent)):
                    row[key].append(us(fn))
                cs.say(f"  us a launch, in turns: parent {row['parent_us'][0]:.2f}, "
                       f"this {row['this_us'][0]:.2f}, this {row['this_us'][1]:.2f}, "
                       f"parent {row['parent_us'][1]:.2f}")
            report["shapes"][label] = row

        # this design's chain in its links at B 1, H 256, K 1,024
        problem = problems[0][1]
        split = _split(lib, problem, us)
        split["stamped_cycles"] = _stamped(lib, problem)
        report["split"] = split
        cs.say(f"links at {SHAPES[0][0]} ({split['ctas']} block(s) of "
               f"{split['threads']} threads, {split['staged_bytes']} B staged), us a "
               "launch: " + ", ".join(f"({p}) {t:.2f}" for p, t in split["links_us"].items()))
        cs.say("the kernel's own chain (clock64 cycles a link, the slowest block): "
               + json.dumps(split["stamped_cycles"]))
        report["launch_shapes"] = _launch_shapes(lib, us)
        cs.say("the empty kernel by cluster shape (blocks x threads, 48 KB "
               "shared a block): " + json.dumps(report["launch_shapes"]))
    cs.say(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
