// Fused FAST-16 corner response + 3x3 local-max suppression for sm_90a.
//
// Replaces the TPU kernel jetracer_orbslam2_tpu/ops/pallas_fast.py::
// fast_nms_response.  Same function as
//   nms.local_max_3x3(fast.fast_score_map(img, t, arc_length, border))
// of the port's plain PyTorch ops, bit for bit, for border >= 3.
//
// Bound on this card: one f32 read and one f32 write per pixel, 8*H*W bytes
// (2.46 MB at 640x480), so the kernel is memory-bound on paper and
// launch-bound in practice at pyramid-level sizes.  What the design does
// about it: the ring masks, the two excess sums and the pre-NMS score live
// in registers and shared memory only; device memory sees the image once
// (plus halo re-reads served by L2) and the suppressed response once.
//
// Design: one block per TILE_W x TILE_H output tile.
//   stage 1  load the tile with a 4-pixel halo into shared memory
//            (3 for the ring + 1 for the NMS), 0 outside the image;
//   stage 2  compute the bordered score for the tile plus a 1-pixel halo
//            into a second shared array;
//   stage 3  write score >= max(8 neighbours) ? score : 0.
// A barrier separates the stages.  The TPU version's (8,128) padding,
// whole-image residency, circular rolls and scratch refs do not carry over.
//
// Exactness: the 16 excess terms are accumulated in the order i = 0..15 in
// f32; the sum holds no multiply, so no FMA contraction can change it.  Do
// not build with --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int THREADS = 256;
constexpr int HALO = 4;                       // ring radius 3 + NMS radius 1
constexpr int IN_W = TILE_W + 2 * HALO;       // 40
constexpr int IN_H = TILE_H + 2 * HALO;       // 24
constexpr int SC_W = TILE_W + 2;              // 34
constexpr int SC_H = TILE_H + 2;              // 18

// One ring pixel: compare against +-t, set its mask bit, add its excess.
// Statements (not a loop over a table) so every offset is a compile-time
// constant and the order of the 16 additions is the order written below.
#define FAST_RING_STEP(k, dy, dx)                                          \
    {                                                                      \
        const float d = tile[cy + (dy)][cx + (dx)] - c;                    \
        if (d > t) { bright |= (1u << (k)); bsum = bsum + (d - t); }       \
        if (d < -t) { dark |= (1u << (k)); dsum = dsum + ((-d) - t); }     \
    }

// True if the 16-bit ring mask holds a circular run of >= len set bits.
__device__ __forceinline__ bool has_arc(unsigned m, int len) {
    if (__popc(m) < len) return false;
    const unsigned mm = m | (m << 16);        // doubled mask unrolls the circle
    unsigned run = mm;
    for (int j = 1; j < len; ++j) run &= (mm >> j);
    return (run & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(THREADS)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int h, int w, float t, int arc_length, int border) {
    __shared__ float tile[IN_H][IN_W];
    __shared__ float score[SC_H][SC_W];

    const int x0 = blockIdx.x * TILE_W;
    const int y0 = blockIdx.y * TILE_H;
    const int tid = threadIdx.x;

    // stage 1: image tile + 4-pixel halo, zero outside the image
    for (int i = tid; i < IN_H * IN_W; i += THREADS) {
        const int ly = i / IN_W, lx = i - ly * IN_W;
        const int gy = y0 + ly - HALO, gx = x0 + lx - HALO;
        float v = 0.0f;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = img[(size_t)gy * w + gx];
        tile[ly][lx] = v;
    }
    __syncthreads();

    // stage 2: bordered FAST score for the tile + 1-pixel halo
    for (int i = tid; i < SC_H * SC_W; i += THREADS) {
        const int sy = i / SC_W, sx = i - sy * SC_W;
        const int gy = y0 + sy - 1, gx = x0 + sx - 1;
        float s = 0.0f;
        // border >= 3, so every pixel inside the keep-out band has its whole
        // ring inside the image (and inside the loaded halo)
        if (gy >= border && gy < h - border && gx >= border && gx < w - border) {
            const int cy = sy + HALO - 1, cx = sx + HALO - 1;
            const float c = tile[cy][cx];
            unsigned bright = 0u, dark = 0u;
            float bsum = 0.0f, dsum = 0.0f;
            // Bresenham circle of radius 3, clockwise from 12 o'clock
            FAST_RING_STEP(0, -3, 0)   FAST_RING_STEP(1, -3, 1)
            FAST_RING_STEP(2, -2, 2)   FAST_RING_STEP(3, -1, 3)
            FAST_RING_STEP(4, 0, 3)    FAST_RING_STEP(5, 1, 3)
            FAST_RING_STEP(6, 2, 2)    FAST_RING_STEP(7, 3, 1)
            FAST_RING_STEP(8, 3, 0)    FAST_RING_STEP(9, 3, -1)
            FAST_RING_STEP(10, 2, -2)  FAST_RING_STEP(11, 1, -3)
            FAST_RING_STEP(12, 0, -3)  FAST_RING_STEP(13, -1, -3)
            FAST_RING_STEP(14, -2, -2) FAST_RING_STEP(15, -3, -1)
            if (has_arc(bright, arc_length) || has_arc(dark, arc_length))
                s = fmaxf(bsum, dsum);
        }
        score[sy][sx] = s;
    }
    __syncthreads();

    // stage 3: 3x3 local max, ties kept
    for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
        const int ly = i / TILE_W, lx = i - ly * TILE_W;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        const int sy = ly + 1, sx = lx + 1;
        const float s = score[sy][sx];
        float m = score[sy - 1][sx - 1];
        m = fmaxf(m, score[sy - 1][sx]);
        m = fmaxf(m, score[sy - 1][sx + 1]);
        m = fmaxf(m, score[sy][sx - 1]);
        m = fmaxf(m, score[sy][sx + 1]);
        m = fmaxf(m, score[sy + 1][sx - 1]);
        m = fmaxf(m, score[sy + 1][sx]);
        m = fmaxf(m, score[sy + 1][sx + 1]);
        out[(size_t)gy * w + gx] = (s >= m) ? s : 0.0f;
    }
}

}  // namespace

// Plain C entry: enqueue on `stream`, no synchronisation, no allocation.
// Returns the launch's cudaError_t as an int (0 = launched).
extern "C" int fast_nms_launch(const float* img, float* out, int h, int w,
                               float threshold, int arc_length, int border,
                               void* stream) {
    if (h <= 0 || w <= 0) return 0;
    const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H);
    fast_nms_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        img, out, h, w, threshold, arc_length, border);
    return static_cast<int>(cudaGetLastError());
}
