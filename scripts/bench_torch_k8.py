#!/usr/bin/env python3
"""K8 (the mesh's all-reduce) of this tree against a parent checkout's, in
turns; and the kernel's chain split with clock64 marks, beside the earlier
two-barrier design restated with the same marks.

    python3 scripts/bench_torch_k8.py --parent DIR [--cards N]

DIR holds the parent commit unpacked (e.g. `git archive <commit> | tar -x
-C DIR`, into a git-ignored directory).  The parent's K8 is run through the
parent's own wrapper, `DIR/jetracer_orbslam2_torch/ops/fused_allreduce.py`
(`map_peers(rank, world, device)`, `peer_allreduce(x, peers)`), which
builds the parent's `csrc/peer_allreduce.cu` into DIR's own `_build/`: any
parent with that Python interface will do, whatever its kernel's C
signature.

At 1, 48, 2,304 (Gh G^T, 6P x 6P at P 8), 2,688 (an LM iteration's four
pose-sized partials in one buffer), 4,704 (the same four in the JAX
package's layout) and 49,152 floats (the gather of 16,384 x 3), on one rank
(no group: a rank maps nothing) and on three processes on the one card
(over a gloo group, each rank's buffers mapped by CUDA IPC, as
`chip_smoke.py` phase 25 (d)) or, with `--cards N`, on N processes one a
card (NVLink): both kernels' outputs `torch.equal` to the rank-order sum of
the ranks' inputs; device time a call (a replayed CUDA graph of 20 calls,
median of 20; 5 of 5 on three ranks that time-slice one card) in turns
(parent, this, this, parent).  Then the chain split with clock64 marks,
from a harness (SPLIT_SOURCE) that includes this tree's `peer_allreduce.cu`
and runs its block body `allreduce_block` with marks (push, barrier, sum,
end), and the earlier two-barrier kernel restated with marks (staging,
barrier 1, sum, barrier 2) on a second set of buffers that this tree's
`map_peers` maps;
both outputs held `torch.equal` to the rank-order sum: cycles a link,
summed over the chunks, of the slowest block, the median of 20 launches;
beside them the launch (an empty kernel of the same grid through the same
timer).  Prints the card's name and power limit first and a JSON line
last; exits non-zero without a card, when a build fails or when an output
differs.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PKG = "jetracer_orbslam2_torch"
PAYLOADS = (("1", 1), ("48", 48), ("GhG", 48 * 48),
            ("packed", 8 * 36 + 48 * 48 + 2 * 48),
            ("packed_jax_layout", 2 * 48 * 48 + 2 * 48),
            ("gather", 16384 * 3))
RANKS = 3
LINKS = {"this": ("push", "barrier", "sum", "end"),
         "two_barrier": ("staging", "barrier 1", "sum", "barrier 2")}

SPLIT_SOURCE = r"""
#include "peer_allreduce.cu"

namespace {

// the clock64 cycles of each link since the previous mark, summed over the
// chunks, in every thread (thread 0 of a block stores its own)
struct ClockMarks {
  long long last, cycles[4];
  __device__ ClockMarks() {
    for (int i = 0; i < 4; ++i) cycles[i] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void operator()(int i) {
    const long long t = clock64();
    cycles[i] += t - last;
    last = t;
  }
};

__device__ __forceinline__ void store_marks(const ClockMarks& mark, long long* stamps) {
  if (threadIdx.x == 0)
    for (int i = 0; i < 4; ++i) stamps[4 * blockIdx.x + i] = mark.cycles[i];
}

__global__ void __launch_bounds__(kThreads)
k8_stamped(Peers P, const float* in, float* out, long long n, long long cap, int rank,
           int world, unsigned* ctr, long long* stamps) {
  ClockMarks mark;
  allreduce_block(P, in, out, n, cap, rank, world, ctr, mark);
  store_marks(mark, stamps);
}

__global__ void k8_empty(float* out) {
  if (out != nullptr && threadIdx.x == 0) out[blockIdx.x] = 0.0f;
}

// The earlier two-barrier kernel restated with marks, on this tree's
// buffers (its flags and the first slot of its receive area): one block of
// 1,024 threads stages its input, crosses a flag barrier, pulls the ranks'
// staging buffers over NVLink and sums them in rank order, and crosses a
// second barrier before the next chunk may overwrite its staging buffer.
namespace two_barrier {

constexpr int kThreads = 1024;

__device__ void barrier(const Peers& P, int rank, int world, int phase, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int r = 0; r < world; ++r)
      st_release(P.flags[r] + phase * kMaxRanks + rank, epoch);
    const unsigned* mine = P.flags[rank] + phase * kMaxRanks;
    const long long t0 = clock64();
    for (int r = 0; r < world; ++r) {
      while (static_cast<int>(ld_acquire(mine + r) - epoch) < 0) {
        if (clock64() - t0 > (1ll << 35)) __trap();
      }
    }
    __threadfence_system();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
stamped(Peers P, const float* in, float* out, long long n, long long cap, int rank,
        int world, unsigned* epoch_ctr, long long* stamps) {
  ClockMarks mark;
  unsigned epoch = *epoch_ctr;
  float* mine = P.area[rank];
  for (long long base = 0; base < n; base += cap) {
    const long long m = n - base < cap ? n - base : cap;
    ++epoch;
    for (long long i = threadIdx.x; i < m; i += blockDim.x) mine[i] = in[base + i];
    mark(0);
    barrier(P, rank, world, 0, epoch);
    mark(1);
    for (long long i = threadIdx.x; i < m; i += blockDim.x) {
      float s = P.area[0][i];
      for (int r = 1; r < world; ++r) s += P.area[r][i];
      out[base + i] = s;
    }
    mark(2);
    barrier(P, rank, world, 1, epoch);
    mark(3);
  }
  if (threadIdx.x == 0) *epoch_ctr = epoch;
  store_marks(mark, stamps);
}

}  // namespace two_barrier
}  // namespace

extern "C" int k8_stamped_launch(void* const* bases, const float* in, float* out,
                                 long long n, long long cap, int rank, int world,
                                 unsigned* ctr, int blocks, long long* stamps,
                                 cudaStream_t s) {
  cudaError_t err = check_args(cap, rank, world, blocks);
  if (err != cudaSuccess) return err;
  k8_stamped<<<blocks, kThreads, 0, s>>>(peers_of(bases, world), in, out, n, cap, rank,
                                          world, ctr, stamps);
  return cudaGetLastError();
}

extern "C" int k8_two_barrier_stamped_launch(void* const* bases, const float* in,
                                             float* out, long long n, long long cap,
                                             int rank, int world, unsigned* epoch,
                                             long long* stamps, cudaStream_t s) {
  cudaError_t err = check_args(cap, rank, world, 1);
  if (err != cudaSuccess) return err;
  two_barrier::stamped<<<1, two_barrier::kThreads, 0, s>>>(
      peers_of(bases, world), in, out, n, cap, rank, world, epoch, stamps);
  return cudaGetLastError();
}

extern "C" int k8_empty_launch(int blocks, int threads, cudaStream_t s) {
  k8_empty<<<blocks, threads, 0, s>>>(nullptr);
  return cudaGetLastError();
}
"""


def tree_wrapper(tree: Path):
    """`tree`'s own K8 wrapper (`ops/fused_allreduce`), imported from `tree`
    beside this tree's package: this tree's modules leave `sys.modules`
    while it loads and come back after, so each module object keeps its own
    tree's build, library and launch counter."""
    def ours() -> dict:
        return {k: m for k, m in sys.modules.items()
                if k == PKG or k.startswith(PKG + ".")}

    saved = ours()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(tree))
    try:
        module = importlib.import_module(PKG + ".ops.fused_allreduce")
    finally:
        sys.path.remove(str(tree))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    if not Path(module.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"FAIL: {module.__file__} is not the parent's")
    return module


def build() -> None:
    """This tree's kernel and the split harness, into _build/ (before any
    rank process starts; the parent's builds at its first `map_peers`)."""
    from jetracer_orbslam2_torch.utils import cuda_build

    cuda_build.build_libraries(["peer_allreduce"])
    harness = cuda_build.BUILD_DIR / "k8_split.cu"
    harness.write_text(SPLIT_SOURCE)
    out = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                          str(cuda_build.CSRC_DIR), "-o",
                          str(cuda_build.BUILD_DIR / "k8_split.so"), str(harness)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"FAIL: nvcc on {harness}:\n{out.stdout}{out.stderr}")


def _split_library():
    """The split harness loaded from _build/, argument types set."""
    from jetracer_orbslam2_torch.utils import cuda_build

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    split = ctypes.CDLL(str(cuda_build.BUILD_DIR / "k8_split.so"))
    split.k8_stamped_launch.argtypes = [ctypes.POINTER(ptr), ptr, ptr, i64, i64,
                                        i32, i32, ptr, i32, ptr, ptr]
    split.k8_two_barrier_stamped_launch.argtypes = [
        ctypes.POINTER(ptr), ptr, ptr, i64, i64, i32, i32, ptr, ptr, ptr]
    split.k8_empty_launch.argtypes = [i32, i32, ptr]
    for fn in (split.k8_stamped_launch, split.k8_two_barrier_stamped_launch,
               split.k8_empty_launch):
        fn.restype = i32
    return split


def _check(err: int, what: str) -> None:
    if err != 0:
        raise SystemExit(f"FAIL: {what}: cudaError {err}")


def _inputs(n: int, world: int, dev) -> tuple:
    """Every rank's input from its seed and their rank-order sum."""
    import torch

    xs = [torch.randn(n, generator=torch.Generator().manual_seed(31 * n + r)).to(dev)
          for r in range(world)]
    want = xs[0].clone()
    for x in xs[1:]:
        want = want + x
    return xs, want


def _stamped(split, kernel: str, peers, x, blocks: int, runs: int = 25) -> tuple:
    """A kernel's chain from its stamped body: (cycles a link, the median
    over launches (the first 5 dropped) of the largest over the blocks; the
    last launch's output)."""
    import torch

    from jetracer_orbslam2_torch.ops import fused_allreduce as far

    stream = torch.cuda.current_stream().cuda_stream
    stamps = torch.zeros(4 * far.MAX_BLOCKS, dtype=torch.int64, device=x.device)
    launch = (split.k8_stamped_launch if kernel == "this"
              else split.k8_two_barrier_stamped_launch)
    rows = []
    for _ in range(runs):
        stamps.zero_()
        buf = x.clone()
        args = (peers.bases, buf.data_ptr(), buf.data_ptr(), buf.numel(),
                far.STAGING_FLOATS, peers.rank, peers.world, peers.epoch.data_ptr())
        args += (blocks,) if kernel == "this" else ()
        _check(launch(*args, stamps.data_ptr(), stream),
               f"the stamped {kernel} kernel's launch")
        torch.cuda.synchronize()
        rows.append(stamps.view(far.MAX_BLOCKS, 4).cpu())
    return {name: statistics.median(int(r[:, i].max()) for r in rows[5:])
            for i, name in enumerate(LINKS[kernel])}, buf


def _mapped(wrapper, rank: int, world: int, dev, whose: str):
    peers = wrapper.map_peers(rank, world, dev)
    if peers is None:
        raise SystemExit(f"FAIL: {whose} map_peers gave no buffers on one host")
    return peers


def measure(parent_dir: Path, rank: int, world: int, dev, reps: int,
            batch: int) -> dict:
    """Both trees' K8 at every payload on this rank of the default group:
    outputs against the rank-order sum, µs a call in turns, then the split
    of this tree's chain and of the two-barrier design."""
    import torch

    import chip_smoke as cs
    from jetracer_orbslam2_torch.ops import fused_allreduce as far

    parent = tree_wrapper(parent_dir)
    split = _split_library()
    # every rank maps in the same order (each map with more than one rank is
    # a collective, and so is each close)
    buffers = [_mapped(far, rank, world, dev, "this tree's"),
               _mapped(parent, rank, world, dev, "the parent's"),
               _mapped(far, rank, world, dev, "the split's")]
    peers, parent_peers, two_barrier_peers = buffers
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def us(fn) -> float:
        return cs.time_launches(fn, reps=reps, batch=batch) * 1e3

    report = {"rank": rank, "world": world, "parent": str(parent.__file__),
              "payloads": {}}
    try:
        for label, n in PAYLOADS:
            xs, want = _inputs(n, world, dev)
            x = xs[rank]
            mine, theirs = x.clone(), x.clone()

            def run_parent(buf=theirs):
                parent.peer_allreduce(buf, parent_peers)

            def run_this(buf=mine):
                far.peer_allreduce(buf, peers)

            run_parent()
            run_this()
            torch.cuda.synchronize()
            blocks = far.launch_blocks(n, world)
            split_this, got_this = _stamped(split, "this", peers, x, blocks)
            split_two, got_two = _stamped(split, "two_barrier",
                                          two_barrier_peers, x, 1)
            equal = {"this": bool(torch.equal(mine, want)),
                     "parent": bool(torch.equal(theirs, want)),
                     "stamped_this": bool(torch.equal(got_this, want)),
                     "stamped_two_barrier": bool(torch.equal(got_two, want))}
            if not all(equal.values()):
                raise SystemExit(f"FAIL: K8 at {label} ({n} floats) on rank "
                                 f"{rank}: {equal}")
            row = {"floats": n, "blocks": blocks, "equal": equal,
                   "parent_us": [], "this_us": []}
            for key, fn in (("parent_us", run_parent), ("this_us", run_this),
                            ("this_us", run_this), ("parent_us", run_parent)):
                row[key].append(us(fn))
            row["launch_us"] = {
                "this": us(lambda: _check(split.k8_empty_launch(
                    blocks, 512, stream()), "the empty launch")),
                "two_barrier": us(lambda: _check(split.k8_empty_launch(
                    1, 1024, stream()), "the empty launch"))}
            row["split_cycles"] = {"this": split_this, "two_barrier": split_two}
            row["bound_us"] = far.bound_seconds(n, world) * 1e6
            report["payloads"][label] = row
        torch.cuda.synchronize()
    finally:
        for b in buffers:
            b.close()
    report["clocks_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return report


def rank_main(parent: Path, store: str, world: int, rank: int,
              cards: bool) -> int:
    """One of the ranks started by `main`: on the one card (time-sliced), or
    on cuda:RANK with `cards`."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank if cards else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=5))
    try:
        report = measure(parent, rank, world, dev, reps=20 if cards else 5,
                         batch=20 if cards else 5)
    finally:
        dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    return 0


def _ranks(parent: Path, world: int, cards: bool) -> list:
    procs = []
    with tempfile.TemporaryDirectory(prefix="jetracer_k8_bench_") as tmp:
        try:
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parent", str(parent),
                 "--rank", os.path.join(tmp, "store"), str(world), str(r)]
                + (["--cards", str(world)] if cards else []),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(world)]
            outs = []
            for p in procs:
                o, e = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise SystemExit(f"FAIL: a rank exited {p.returncode}:\n"
                                     + e[-3000:])
                outs.append(json.loads(o.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return outs


def _say_rows(title: str, report: dict) -> None:
    print(title, flush=True)
    for label, row in report["payloads"].items():
        print(f"  {label} ({row['floats']} floats, {row['blocks']} block(s)): "
              f"us in turns parent {row['parent_us'][0]:.2f}, this "
              f"{row['this_us'][0]:.2f}, this {row['this_us'][1]:.2f}, parent "
              f"{row['parent_us'][1]:.2f}; launch {row['launch_us']}; cycles "
              f"{row['split_cycles']}; bound {row['bound_us']:.4f} us",
              flush=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the parent commit unpacked")
    ap.add_argument("--cards", type=int, default=0, metavar="N",
                    help="the ranks one a card on N cards, in place of "
                         f"{RANKS} processes on the one card")
    ap.add_argument("--rank", nargs=3, metavar=("STORE", "WORLD", "RANK"),
                    help=argparse.SUPPRESS)   # one of the ranks (internal)
    args = ap.parse_args(argv)
    parent = args.parent.resolve()
    if not (parent / PKG / "ops" / "fused_allreduce.py").is_file():
        print(f"bench_torch_k8: {parent} holds no {PKG}/ops/fused_allreduce.py",
              file=sys.stderr)
        return 1

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_k8: no CUDA device", file=sys.stderr)
        return 1
    if args.rank:
        store, world, rank = args.rank
        return rank_main(parent, store, int(world), int(rank), args.cards > 1)
    if args.cards > torch.cuda.device_count():
        print(f"bench_torch_k8: --cards {args.cards} on "
              f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    cs.say(cs.card_line())
    set_exact_f32()
    build()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # no group: nothing to map; the parent's kernel builds here, before the
    # ranks start
    one = measure(parent, 0, 1, dev, reps=20, batch=20)
    _say_rows("one rank:", one)
    cards = args.cards > 1
    world = args.cards if cards else RANKS
    ranks = _ranks(parent, world, cards)
    if len({json.dumps({k: r["equal"] for k, r in o["payloads"].items()})
            for o in ranks}) != 1:
        raise SystemExit("FAIL: the ranks disagree")
    _say_rows(f"{world} ranks on {world if cards else 'the one'} card(s) "
              "(rank 0):", ranks[0])
    cs.say(json.dumps({"one_rank": one, "ranks": ranks,
                       "ranks_on": f"{world} cards" if cards else "one card"}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
