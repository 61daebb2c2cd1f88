// Fused FAST-16 corner response + 3x3 local-max suppression for sm_90a, for
// every level of an image pyramid and one or two thresholds in ONE launch.
//
// Replaces the TPU kernel jetracer_orbslam2_tpu/ops/pallas_fast.py::
// fast_nms_response.  For each level L and threshold t, the same function as
//   nms.local_max_3x3(fast.fast_score_map(L, t, arc_length, border))
// of the port's plain PyTorch ops, bit for bit, for border >= 3.
//
// Bound on this card: each level read once and each (level, threshold)
// response written once: 4*(1 + T)*sum(H*W) bytes, 3,264,000 B = 0.97 us
// (one threshold) and 4,896,000 B = 1.46 us (two) for the 640x480 4-level
// pyramid at 3.35 TB/s.  The arithmetic (about 60 counted f32 operations a
// pixel at one threshold, 113 at two) lies below that at 67 TFLOP/s, so the
// kernel is memory-bound on paper; at these sizes a
// launch's fixed cost (3-4 us) and the latency of one load -> score -> max
// chain are what a launch costs.  What the design does about it:
//   * one launch a frame.  A by-value table (up to 8 levels: input, one output
//     per threshold, h, w, the prefix of tile counts) lets the block index
//     run over the flattened tiles of all levels: 802 tiles of 32x16 at
//     640x480, so the small levels no longer pay a launch each for 12-150
//     blocks;
//   * the 16 ring differences are computed once a pixel; each threshold keeps
//     its own masks and excess sums, so the second threshold costs compares
//     and adds, not a second pass over the image;
//   * one block per tile, at most 32 registers a thread, so that all 802
//     tiles are resident at once (8 blocks an SM): one block's copy overlaps
//     another block's score and max.  A persistent grid of 1 or 2 blocks an
//     SM, each copying its next tile into a double buffer while it scored the
//     current one, was measured on an H100 and was slower (10.2 and 15.2
//     against 8.6 us a frame at one threshold; PERF.md, PR 4): fewer blocks
//     keep fewer loads in flight than the resident blocks already do.  So
//     were 32x32 tiles (406 blocks: 9.2 against 8.0 us);
//   * the tile + halo is staged with cp.async (16-byte copies where a level's
//     rows allow it, 4-byte copies with zero fill otherwise: the fill is the
//     "0 outside the image" of the plain version).  cp.async was kept over a
//     TMA tile load: a TMA descriptor is per level and per base address,
//     made on the host for every frame's fresh tensors, and a level whose
//     rows are not 16-byte aligned (odd widths) cannot use one at all.
//
// Per tile (256 threads, TILE_W x TILE_H outputs):
//   stage 1  the tile with a 4-pixel halo (3 for the ring + 1 for the NMS),
//            0 outside the image, in shared memory;
//   stage 2  the bordered score, per threshold, for the tile plus a 1-pixel
//            halo into a second shared array; a pixel whose four compass
//            pixels already rule out an arc at every threshold skips the
//            ring (exact: its score is 0 either way);
//   stage 3  out = score >= max(8 neighbours) ? score : 0, per threshold.
// Two barriers a tile.  The TPU version's (8,128) padding, whole-image
// residency, circular rolls and scratch refs do not carry over.
//
// Exactness: the 16 excess terms of each threshold are accumulated in the
// order i = 0..15 in f32; the sum holds no multiply, so no FMA contraction can
// change it.  Do not build with --use_fast_math.

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
constexpr int MAX_LEVELS = 8;
constexpr int MAX_THRESHOLDS = 2;

// The launch's levels, passed by value (__grid_constant__: read in place).
struct Pyramid {
    const float* img[MAX_LEVELS];
    float* out[MAX_THRESHOLDS][MAX_LEVELS];
    int h[MAX_LEVELS];
    int w[MAX_LEVELS];
    int tiles_x[MAX_LEVELS];
    int vec4[MAX_LEVELS];                     // rows start 16-byte aligned
    int tile_start[MAX_LEVELS + 1];           // prefix of the tile counts
    float t[MAX_THRESHOLDS];
    int levels;
    int arc_length;
    int border;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int level_of(const Pyramid& p, int tile) {
    int lev = 0;
    while (tile >= p.tile_start[lev + 1]) ++lev;
    return lev;
}

// Stage 1 of `tile`: its input window into `buf`, zero outside the image.
// A copy whose source lies outside reads nothing (src-size 0); its address
// is the level's base so that it is a valid one all the same.
__device__ __forceinline__ void load_tile(const Pyramid& p, int tile,
                                          float (*buf)[IN_W]) {
    const int lev = level_of(p, tile);
    const int local = tile - p.tile_start[lev];
    const int ty = local / p.tiles_x[lev], tx = local - ty * p.tiles_x[lev];
    const int y0 = ty * TILE_H - HALO, x0 = tx * TILE_W - HALO;
    const int h = p.h[lev], w = p.w[lev];
    const float* img = p.img[lev];
    if (p.vec4[lev]) {
        // w % 4 == 0 and x0 % 4 == 0: a 4-pixel chunk is all in or all out
        constexpr int CW = IN_W / 4;
        for (int i = threadIdx.x; i < IN_H * CW; i += THREADS) {
            const int ly = i / CW, lx = 4 * (i - ly * CW);
            const int gy = y0 + ly, gx = x0 + lx;
            const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
            cp_async16(&buf[ly][lx], ok ? img + (size_t)gy * w + gx : img, ok);
        }
    } else {
        for (int i = threadIdx.x; i < IN_H * IN_W; i += THREADS) {
            const int ly = i / IN_W, lx = i - ly * IN_W;
            const int gy = y0 + ly, gx = x0 + lx;
            const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
            cp_async4(&buf[ly][lx], ok ? img + (size_t)gy * w + gx : img, ok);
        }
    }
}

// One ring pixel: its difference to the centre once, then, per threshold,
// compare against +-t, set the mask bit and add the excess.  Statements (not
// a loop over a table) so every offset is a compile-time constant and the
// order of the 16 additions is the order written below.
#define FAST_RING_STEP(k, dy, dx)                                              \
    {                                                                          \
        const float d = in[cy + (dy)][cx + (dx)] - c;                          \
        _Pragma("unroll")                                                      \
        for (int j = 0; j < NT; ++j) {                                         \
            if (d > t[j]) { bright[j] |= (1u << (k)); bsum[j] = bsum[j] + (d - t[j]); } \
            if (d < -t[j]) { dark[j] |= (1u << (k)); dsum[j] = dsum[j] + ((-d) - t[j]); } \
        }                                                                      \
    }

// True if the 16-bit ring mask holds a circular run of >= len set bits.
__device__ __forceinline__ bool has_arc(unsigned m, int len) {
    if (__popc(m) < len) return false;
    const unsigned mm = m | (m << 16);        // doubled mask unrolls the circle
    unsigned run = mm;
    for (int j = 1; j < len; ++j) run &= (mm >> j);
    return (run & 0xFFFFu) != 0u;
}

// Exact early rejection.  Any run of n contiguous ring pixels holds at least
// n / 4 of the four compass pixels (ring positions 0, 4, 8, 12), so a pixel
// whose compass holds fewer than arc_length / 4 bright and fewer than
// arc_length / 4 dark pixels at every threshold fails the arc test, and its
// score is 0 whatever its excess sums would be.  False means "score 0".
template <int NT>
__device__ __forceinline__ bool compass_may_pass(const float (*in)[IN_W], int cy,
                                                 int cx, const float* t,
                                                 int arc_length) {
    const int need = arc_length / 4;
    const float c = in[cy][cx];
    const float d0 = in[cy - 3][cx] - c, d4 = in[cy][cx + 3] - c;
    const float d8 = in[cy + 3][cx] - c, d12 = in[cy][cx - 3] - c;
    bool may = false;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int nb = (d0 > t[j]) + (d4 > t[j]) + (d8 > t[j]) + (d12 > t[j]);
        const int nd = (d0 < -t[j]) + (d4 < -t[j]) + (d8 < -t[j]) + (d12 < -t[j]);
        may = may || nb >= need || nd >= need;
    }
    return may;
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 8)
fast_nms_pyramid_kernel(const __grid_constant__ Pyramid p) {
    __shared__ __align__(16) float in[IN_H][IN_W];
    __shared__ float score[NT][SC_H][SC_W];

    const int tile = blockIdx.x, tid = threadIdx.x;
    float t[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) t[j] = p.t[j];

    // stage 1: the tile and its halo, copied asynchronously
    load_tile(p, tile, in);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    const int lev = level_of(p, tile);
    const int local = tile - p.tile_start[lev];
    const int ty = local / p.tiles_x[lev], tx = local - ty * p.tiles_x[lev];
    const int y0 = ty * TILE_H, x0 = tx * TILE_W;
    const int h = p.h[lev], w = p.w[lev], border = p.border;

    // stage 2: bordered FAST score, per threshold, tile + 1-pixel halo
    for (int i = tid; i < SC_H * SC_W; i += THREADS) {
        const int sy = i / SC_W, sx = i - sy * SC_W;
        const int gy = y0 + sy - 1, gx = x0 + sx - 1;
        float s[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j] = 0.0f;
        // border >= 3, so every pixel inside the keep-out band has its whole
        // ring inside the image (and inside the staged halo)
        const int cy = sy + HALO - 1, cx = sx + HALO - 1;
        if (gy >= border && gy < h - border && gx >= border && gx < w - border &&
            compass_may_pass<NT>(in, cy, cx, t, p.arc_length)) {
            const float c = in[cy][cx];
            unsigned bright[NT], dark[NT];
            float bsum[NT], dsum[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                bright[j] = 0u; dark[j] = 0u; bsum[j] = 0.0f; dsum[j] = 0.0f;
            }
            // Bresenham circle of radius 3, clockwise from 12 o'clock
            FAST_RING_STEP(0, -3, 0)   FAST_RING_STEP(1, -3, 1)
            FAST_RING_STEP(2, -2, 2)   FAST_RING_STEP(3, -1, 3)
            FAST_RING_STEP(4, 0, 3)    FAST_RING_STEP(5, 1, 3)
            FAST_RING_STEP(6, 2, 2)    FAST_RING_STEP(7, 3, 1)
            FAST_RING_STEP(8, 3, 0)    FAST_RING_STEP(9, 3, -1)
            FAST_RING_STEP(10, 2, -2)  FAST_RING_STEP(11, 1, -3)
            FAST_RING_STEP(12, 0, -3)  FAST_RING_STEP(13, -1, -3)
            FAST_RING_STEP(14, -2, -2) FAST_RING_STEP(15, -3, -1)
#pragma unroll
            for (int j = 0; j < NT; ++j)
                if (has_arc(bright[j], p.arc_length) || has_arc(dark[j], p.arc_length))
                    s[j] = fmaxf(bsum[j], dsum[j]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) score[j][sy][sx] = s[j];
    }
    __syncthreads();

    // stage 3: 3x3 local max, ties kept, per threshold
    for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
        const int ly = i / TILE_W, lx = i - ly * TILE_W;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        const int sy = ly + 1, sx = lx + 1;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float (*sc)[SC_W] = score[j];
            const float s = sc[sy][sx];
            float m = sc[sy - 1][sx - 1];
            m = fmaxf(m, sc[sy - 1][sx]);
            m = fmaxf(m, sc[sy - 1][sx + 1]);
            m = fmaxf(m, sc[sy][sx - 1]);
            m = fmaxf(m, sc[sy][sx + 1]);
            m = fmaxf(m, sc[sy + 1][sx - 1]);
            m = fmaxf(m, sc[sy + 1][sx]);
            m = fmaxf(m, sc[sy + 1][sx + 1]);
            p.out[j][lev][(size_t)gy * w + gx] = (s >= m) ? s : 0.0f;
        }
    }
}

}  // namespace

extern "C" int fast_nms_max_levels() { return MAX_LEVELS; }

// Plain C entry: enqueue on `stream`, no synchronisation, no allocation.
// imgs[i] is level i (h[i] x w[i], f32, row-major, contiguous); outs[j *
// levels + i] receives the response of level i at thresholds[j].
// One block per tile.  Returns the launch's cudaError_t as an int (0 = launched; 1 = invalid
// value for a level or threshold count out of range).
extern "C" int fast_nms_pyramid_launch(const float* const* imgs,
                                       float* const* outs, const int* h,
                                       const int* w, int levels,
                                       const float* thresholds,
                                       int n_thresholds, int arc_length,
                                       int border, void* stream) {
    if (levels < 1 || levels > MAX_LEVELS || n_thresholds < 1 ||
        n_thresholds > MAX_THRESHOLDS)
        return static_cast<int>(cudaErrorInvalidValue);
    Pyramid p = {};
    p.levels = levels;
    p.arc_length = arc_length;
    p.border = border;
    for (int j = 0; j < n_thresholds; ++j) p.t[j] = thresholds[j];
    p.tile_start[0] = 0;
    for (int i = 0; i < levels; ++i) {
        const int hh = h[i] > 0 && w[i] > 0 ? h[i] : 0;
        const int ww = hh > 0 ? w[i] : 0;
        p.img[i] = imgs[i];
        for (int j = 0; j < n_thresholds; ++j) p.out[j][i] = outs[j * levels + i];
        p.h[i] = hh;
        p.w[i] = ww;
        p.tiles_x[i] = (ww + TILE_W - 1) / TILE_W;
        p.vec4[i] = ww % 4 == 0 &&
                    reinterpret_cast<unsigned long long>(imgs[i]) % 16 == 0;
        p.tile_start[i + 1] =
            p.tile_start[i] + p.tiles_x[i] * ((hh + TILE_H - 1) / TILE_H);
    }
    if (p.tile_start[levels] == 0) return 0;
    const int grid = p.tile_start[levels];
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_thresholds == 1)
        fast_nms_pyramid_kernel<1><<<grid, THREADS, 0, st>>>(p);
    else
        fast_nms_pyramid_kernel<2><<<grid, THREADS, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
}
