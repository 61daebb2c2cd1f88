// K8: the mesh's all-reduce on the card, eager and inside a CUDA graph's
// conditional body.
//
// Replaces `jax.lax.psum` under `shard_map`
// (jetracer_orbslam2_tpu/models/backend/ba.py:394, no Pallas kernel: XLA's
// all-reduce, which the JAX package runs inside its keyframe `lax.cond`).
// NCCL's captured all-reduce brings event-record and event-wait nodes (its
// graph-mixing support), which a conditional body may not hold: the graph
// does not instantiate.  So each rank owns a receive area that its peers
// map through CUDA IPC (the handles are exchanged once, over the process
// group, when a mesh on the card is set up).  A call (one chunk of at most
// `cap` floats at a time; a larger payload goes in chunks):
//   1. push: each block stores its slice of this rank's partial into this
//      rank's slot of every rank's receive area (16-byte vectors, a scalar
//      tail; NVLink stores are posted, nothing waits on them);
//   2. one flag barrier a block: after __syncthreads(), thread q releases
//      the chunk's epoch into rank q's flag of (this block, this rank) with
//      st.release.sys (cumulative: it publishes the whole block's stores)
//      and waits with ld.acquire.sys until this rank's flag of (this block,
//      rank q) holds it.  A block waits only on the same block of its
//      peers, so there is no grid-wide barrier; the grid is at most
//      kMaxBlocks blocks, all resident at once;
//   3. the block sums its slice of the `world` slots in rank order from
//      local memory (no NVLink read) into the output: every rank the same
//      bits, those of the rank-order sum s = x0 + x1 + ... (whatever the
//      grid, the chunking or the packing of the payload).
// There is no end barrier.  The receive area holds two copies of the
// slots, picked by the parity of the epoch.  A rank writes parity p in
// chunk e + 2 only after its chunk e + 1 saw every peer's flag of e + 1
// (the same block's within a launch; a launch runs only after the previous
// one on its stream has ended, so across launches any block's flag will
// do), and a peer posts that flag only after it finished reading parity p
// in chunk e: calls on a stream run in order, a block posts after its own
// sum (program order), and the flag is written with release semantics.
// One rank has no peer: no barrier and no copy (in place, nothing to sum;
// out of place, a copy), but the launch stays, so a one-rank graph is the
// same program as a many-rank one.
// The epoch lives in device memory (ctr[0]; ctr[1] counts the blocks that
// finished, and the last one advances the epoch), so graph replays keep the
// ranks' flags in step.  A barrier that waits more than about 17 s (a rank
// left the lockstep) traps: the launch fails instead of hanging the card.
// In-place (in == out) is allowed: a block reads and writes only its slice.
//
// Bound, what any all-reduce must move (not what this one-shot push sends,
// (world - 1) * n floats into each rank): the larger of n floats read and n
// written over 3.35 TB/s and the 2 (world - 1) / world * n floats a rank
// must receive over NVLink (a reduce-scatter, then an all-gather) over
// 450 GB/s: 0.031 us at 2,304 floats on four ranks, 0.66 us at 49,152; one
// rank in place moves nothing.  The payloads are small (a packed LM
// iteration's 2,688 floats, the 16,384 x 3 gather), so a call is bound by
// its launch and one NVLink round trip, which is all that one barrier and
// posted stores leave.
//
// Entries (each returns a cudaError_t, 0 = ok): peer_alloc / peer_free (a
// rank's allocation, its flags zeroed), peer_handle / peer_open /
// peer_close (CUDA IPC), peer_handle_bytes, peer_allreduce (the launch).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kMaxBlocks = 16;
constexpr int kThreads = 512;
// a rank's allocation: flags [kMaxBlocks][kMaxRanks] uint32, then the
// receive area [parity 0 | parity 1][world slots][cap floats]
constexpr size_t kFlagBytes = kMaxBlocks * kMaxRanks * sizeof(unsigned);

struct Peers {
  float* area[kMaxRanks];
  unsigned* flags[kMaxRanks];
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// no marks: what the kernel runs
struct NoMarks {
  __device__ __forceinline__ void operator()(int) {}
};

// The call on this block: chunks of at most cap floats, each pushed, one
// barrier, summed.  mark(0) after a chunk's push, mark(1) after its
// barrier, mark(2) after its sum, mark(3) at the end (the epoch advanced).
template <typename Mark>
__device__ __forceinline__ void allreduce_block(const Peers& P, const float* in,
                                                float* out, long long n,
                                                long long cap, int rank, int world,
                                                unsigned* ctr, Mark& mark) {
  if (world == 1) {
    if (in != out)
      for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
           i += (long long)gridDim.x * blockDim.x)
        out[i] = in[i];
    return;
  }
  const unsigned first = *reinterpret_cast<volatile unsigned*>(ctr);
  const long long m0 = n < cap ? n : cap;
  // this block's slice of every chunk: the same offsets in each, a
  // multiple of 4 floats wide
  const long long per = ((m0 + gridDim.x - 1) / gridDim.x + 3) / 4 * 4;
  const long long lo = blockIdx.x * per;
  const bool vec = ((reinterpret_cast<uintptr_t>(in) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  unsigned epoch = first;
  for (long long base = 0; base < n; base += cap) {
    const long long m = n - base < cap ? n - base : cap;
    const long long hi = lo + per < m ? lo + per : m;
    const long long hi4 = vec && hi > lo ? lo + (hi - lo) / 4 * 4 : lo;
    ++epoch;
    const long long slots = static_cast<long long>(epoch & 1) * world * cap;
    const float* src = in + base;
    // 1. push this rank's slice into its slot of every rank's area
    const long long mine = slots + rank * cap;
    for (long long i = lo + 4 * threadIdx.x; i < hi4; i += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q)
        if (q < world) *reinterpret_cast<float4*>(P.area[q] + mine + i) = v;
    }
    for (long long i = hi4 + threadIdx.x; i < hi; i += kThreads) {
      const float v = src[i];
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q)
        if (q < world) P.area[q][mine + i] = v;
    }
    mark(0);
    // 2. one barrier: thread q posts to rank q and waits for rank q
    __syncthreads();
    if (threadIdx.x < world) {
      const int q = threadIdx.x;
      st_release(P.flags[q] + blockIdx.x * kMaxRanks + rank, epoch);
      const unsigned* flag = P.flags[rank] + blockIdx.x * kMaxRanks + q;
      const long long t0 = clock64();
      while (static_cast<int>(ld_acquire(flag) - epoch) < 0) {
        if (clock64() - t0 > (1ll << 35)) __trap();
      }
    }
    __syncthreads();
    mark(1);
    // 3. the rank-order sum of the slots, from local memory
    const float* area = P.area[rank] + slots;
    float* dst = out + base;
    for (long long i = lo + 4 * threadIdx.x; i < hi4; i += 4 * kThreads) {
      float4 s = __ldcg(reinterpret_cast<const float4*>(area + i));
      for (int r = 1; r < world; ++r) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(area + r * cap + i));
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      *reinterpret_cast<float4*>(dst + i) = s;
    }
    for (long long i = hi4 + threadIdx.x; i < hi; i += kThreads) {
      float s = __ldcg(area + i);
      for (int r = 1; r < world; ++r) s += __ldcg(area + r * cap + i);
      dst[i] = s;
    }
    mark(2);
  }
  // the last block to finish advances the epoch (every block read it first)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctr + 1, 1u) == gridDim.x - 1) {
      ctr[0] = epoch;
      ctr[1] = 0;
    }
  }
  mark(3);
}

__global__ void __launch_bounds__(kThreads)
peer_allreduce_kernel(Peers P, const float* in, float* out, long long n,
                      long long cap, int rank, int world, unsigned* ctr) {
  NoMarks none;
  allreduce_block(P, in, out, n, cap, rank, world, ctr, none);
}

// every rank's allocation (bases, in rank order) as this process sees it
__host__ Peers peers_of(void* const* bases, int world) {
  Peers P;
  for (int r = 0; r < kMaxRanks; ++r) {
    char* b = r < world ? static_cast<char*>(bases[r]) : nullptr;
    P.flags[r] = reinterpret_cast<unsigned*>(b);
    P.area[r] = reinterpret_cast<float*>(b ? b + kFlagBytes : nullptr);
  }
  return P;
}

__host__ cudaError_t check_args(long long cap, int rank, int world, int blocks) {
  if (world < 1 || world > kMaxRanks || rank < 0 || rank >= world || cap < 4 ||
      cap % 4 != 0 || blocks < 1 || blocks > kMaxBlocks)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// An allocation of `bytes` of receive area (zeroed flags before it); *ptr is
// its base, which peer_handle exports.
extern "C" int peer_alloc(size_t bytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, kFlagBytes + bytes);
  if (err != cudaSuccess) return err;
  return cudaMemset(*ptr, 0, kFlagBytes);
}

extern "C" int peer_free(void* ptr) { return cudaFree(ptr); }

extern "C" int peer_handle(void* ptr, void* handle) {
  return cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr);
}

extern "C" int peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int peer_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

extern "C" size_t peer_handle_bytes() { return sizeof(cudaIpcMemHandle_t); }

// bases: every rank's allocation as this process sees it (its own, or the
// mapped peer's), in rank order; each holds 2 * world * cap floats of
// receive area.  ctr: this rank's two uint32 counters (epoch, blocks done).
// blocks: the grid, 1..kMaxBlocks (the wrapper's `launch_blocks`).
extern "C" int peer_allreduce(void* const* bases, const float* in, float* out,
                              long long n, long long cap, int rank, int world,
                              unsigned* ctr, int blocks, cudaStream_t stream) {
  cudaError_t err = check_args(cap, rank, world, blocks);
  if (err != cudaSuccess) return err;
  peer_allreduce_kernel<<<blocks, kThreads, 0, stream>>>(
      peers_of(bases, world), in, out, n, cap, rank, world, ctr);
  return cudaGetLastError();
}
