// Helpers for the port's kernels that split one problem over a thread-block
// cluster (csrc/pose_polish.cu, csrc/ransac_hyp.cu), in PTX for sm_90a:
//   - the cluster barrier, split into arrive and wait;
//   - a shared-memory barrier (mbarrier) that counts the bytes other blocks
//     of the cluster store into this block's shared memory with st.async:
//     a block waits for exactly the bytes it expects, with no barrier
//     across the cluster and no round trip for the sender.
// Every function is inline and has internal linkage; the including source
// is one translation unit of its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The cluster barrier split in two: arrive (release: this thread's earlier
// stores, an mbarrier's initialisation included, become visible to the
// cluster) and wait (acquire: every block has arrived, so it runs).
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of this block's shared-memory location `local` (a
// shared::cta address) in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned local, unsigned rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(local), "r"(rank));
    return out;
}

// An mbarrier that completes a phase on one arrival and the bytes expected.
// The initialising thread fences, and the cluster barrier that follows
// releases the initialisation to the other blocks.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This block's one arrival on the phase, expecting `bytes` of st.async.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of this parity has completed (acquire at cluster
// scope: the stores of other blocks that completed it are visible).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// Stores into another block's shared memory (shared::cluster addresses of
// the location and of that block's mbarrier), completing as many bytes of
// the mbarrier's phase.
__device__ __forceinline__ void st_async(unsigned addr, double v, unsigned bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
                 :: "r"(addr), "l"(__double_as_longlong(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, unsigned v, unsigned bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                 :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

}  // namespace
