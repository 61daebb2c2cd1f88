// Keypoint patch gather for sm_90a: out[k, i, j] = canvas[ys[k] + i, xs[k] + j].
//
// Replaces the TPU kernel scripts/experiment_pallas_patches.py::make_kernel /
// pallas_extract, which computes ops/patches.extract_patches: a (P, P) window
// of the packed pyramid canvas per keypoint, a pure copy of pixels.
//
// Bound on this card: bytes, each input read once and the output written
// once.  K*P*P*4 written (5.6 MB at K = 1024, P = 37), the canvas (2.3 MB at
// 640x480, four levels) and the 8 KB of origins read: 7.9 MB against
// 3.35 TB/s is 2.4 us, the size of a launch.  Overlapping windows read the
// same pixels again, but the canvas is in L2 after the pyramid, so those
// reads do not reach device memory.
// What the design does about it: nothing is staged and nothing is computed
// but addresses; one block per keypoint, consecutive threads on consecutive
// output elements, so a warp's stores are one contiguous run and its loads
// are at most two runs of a canvas row (a patch row is 37 neighbours).
//
// The TPU version's aligned 48x256 window, its two rolls, its 128-lane output
// and its batch of keypoints per grid step answer the TPU's tiling and are
// not carried over.  Reads are clamped into the canvas: a window of a valid
// keypoint never leaves it (the caller clamps the centre into the keypoint's
// level), and a never-valid keypoint on a level smaller than the patch must
// not fault.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
patch_gather_kernel(const float* __restrict__ canvas,
                    const int* __restrict__ ys, const int* __restrict__ xs,
                    float* __restrict__ out, int rows, int cols, int p) {
    const int k = blockIdx.x;
    const int y0 = ys[k];
    const int x0 = xs[k];
    const int n = p * p;
    float* dst = out + (size_t)k * n;
    for (int e = threadIdx.x; e < n; e += THREADS) {
        const int i = e / p;
        const int j = e - i * p;
        const int y = min(max(y0 + i, 0), rows - 1);
        const int x = min(max(x0 + j, 0), cols - 1);
        dst[e] = __ldg(canvas + (size_t)y * cols + x);
    }
}

}  // namespace

// Plain C entry: enqueue on `stream`, no synchronisation, no allocation.
// Returns the launch's cudaError_t as an int (0 = launched).
extern "C" int patch_gather_launch(const float* canvas, const int* ys,
                                   const int* xs, float* out, int rows,
                                   int cols, int num_keypoints, int patch,
                                   void* stream) {
    if (num_keypoints <= 0 || patch <= 0 || rows <= 0 || cols <= 0) return 0;
    patch_gather_kernel<<<num_keypoints, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        canvas, ys, xs, out, rows, cols, patch);
    return static_cast<int>(cudaGetLastError());
}
