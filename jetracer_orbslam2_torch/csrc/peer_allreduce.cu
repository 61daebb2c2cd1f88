// K8: the mesh's all-reduce on the card, eager and inside a CUDA graph's
// conditional body.
//
// Replaces `jax.lax.psum` under `shard_map`
// (jetracer_orbslam2_tpu/models/backend/ba.py:394, no Pallas kernel: XLA's
// all-reduce, which the JAX package runs inside its keyframe `lax.cond`).
// NCCL's captured all-reduce brings event-record and event-wait nodes (its
// graph-mixing support), which a conditional body may not hold: the graph
// does not instantiate.  So each rank owns a staging buffer that its peers
// map through CUDA IPC (the handles are exchanged once, over the process
// group, when a mesh on the card is set up), and one block of this kernel:
//   1. copies its input into its own staging buffer;
//   2. a flag barrier: thread 0 stores the call's epoch into a flag of every
//      rank's buffer (release, system scope) and waits until every rank's
//      flag in its own buffer holds it (acquire);
//   3. sums the staging buffers in rank order into the output (every rank
//      the same bits; on one rank a copy);
//   4. a second barrier, so that no rank overwrites its staging buffer
//      while a peer still reads it.
// The epoch lives in device memory and the kernel advances it, so graph
// replays keep the ranks' flags in step.  A payload larger than the staging
// buffer goes in chunks, two barriers each.  A barrier that waits more than
// about 17 s (a rank left the lockstep) traps: the launch fails instead of
// hanging the card.  In-place (in == out) is allowed.
//
// Bound: bytes.  A rank reads n floats and writes n (the function's own
// input and output), and reads world * n more over NVLink; the payloads are
// small (a 6P x 6P partial, the 16,384 x 3 gather), so the two barriers'
// round trips bound a call.  One block: a simple kernel that is right.
//
// Entries (each returns a cudaError_t, 0 = ok): peer_alloc / peer_free (a
// rank's staging buffer, its flags zeroed), peer_handle / peer_open /
// peer_close (CUDA IPC), peer_handle_bytes, peer_allreduce (the launch).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kThreads = 1024;
// flags: [phase 0 | phase 1][kMaxRanks] uint32, then the data
constexpr size_t kFlagBytes = 256;

struct Peers {
  float* data[kMaxRanks];
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

__device__ void barrier(const Peers& P, int rank, int world, int phase,
                        unsigned epoch) {
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
peer_allreduce_kernel(Peers P, const float* in, float* out, long long n,
                      long long cap, int rank, int world, unsigned* epoch_ctr) {
  unsigned epoch = *epoch_ctr;
  float* mine = P.data[rank];
  for (long long base = 0; base < n; base += cap) {
    const long long m = n - base < cap ? n - base : cap;
    ++epoch;
    for (long long i = threadIdx.x; i < m; i += blockDim.x) mine[i] = in[base + i];
    barrier(P, rank, world, 0, epoch);
    for (long long i = threadIdx.x; i < m; i += blockDim.x) {
      float s = P.data[0][i];
      for (int r = 1; r < world; ++r) s += P.data[r][i];
      out[base + i] = s;
    }
    barrier(P, rank, world, 1, epoch);
  }
  if (threadIdx.x == 0) *epoch_ctr = epoch;
}

}  // namespace

// A staging buffer of `bytes` of data (zeroed flags before it); *ptr is the
// base of the allocation, which peer_handle exports.
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
// mapped peer's), in rank order.
extern "C" int peer_allreduce(void* const* bases, const float* in, float* out,
                              long long n, long long cap, int rank, int world,
                              unsigned* epoch, cudaStream_t stream) {
  if (world < 1 || world > kMaxRanks || rank < 0 || rank >= world || cap < 1)
    return cudaErrorInvalidValue;
  Peers P;
  for (int r = 0; r < kMaxRanks; ++r) {
    char* b = r < world ? static_cast<char*>(bases[r]) : nullptr;
    P.flags[r] = reinterpret_cast<unsigned*>(b);
    P.data[r] = reinterpret_cast<float*>(b ? b + kFlagBytes : nullptr);
  }
  peer_allreduce_kernel<<<1, kThreads, 0, stream>>>(P, in, out, n, cap, rank,
                                                    world, epoch);
  return cudaGetLastError();
}
