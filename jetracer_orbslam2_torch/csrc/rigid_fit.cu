// Weighted rigid fit (Kabsch) for sm_90a: a batch of B problems of N point
// pairs, src, dst (B, N, 3) f32 and weights (B, N) f32 (or none: all 1), to
// (B, 4, 4) f32 transforms T with dst ~= T @ src.
//
// Replaces no TPU kernel: the JAX package computes kabsch with
// jnp.linalg.svd (jetracer_orbslam2_tpu/ops/geometry.py::kabsch), outside any
// Pallas kernel.  On the card the port's plain route, torch.linalg.svd, makes
// the host wait (cuSOLVER's info check reads the device back), so a frame
// step that refits with it cannot be captured into a CUDA graph.  This kernel
// computes the same transform with no host wait and no allocation.
//
// What it computes, per problem (the plain version's steps, in f64):
//   wsum = max(sum w, 1e-9);  mu_s = sum w src / wsum;  mu_d = sum w dst / wsum
//   H = sum w (src - mu_s)(dst - mu_d)^T                            (3 x 3)
//   H = U S V^T by a one-sided Jacobi of fixed sweeps, S sorted descending
//   R = V diag(1, 1, sign det(V U^T)) U^T;  t = mu_d - R mu_s
// U's third column is u1 x u2 (and its second, when H has rank < 2, a unit
// vector orthogonal to u1), so U is a proper rotation whatever the rank of H:
// coplanar and collinear points give a proper R, and H = 0 (all weights 0)
// gives R = I, as the SVD route does.
//
// Layout: one block of 256 threads a problem.  Each thread sums its strided
// points in f64; the block adds the partials by warp shuffles then over the
// warps in a fixed order, with no atomics, so a relaunch and a graph replay
// give the same bits.  One thread then factors H and writes T.
//
// Bound on this card: a launch.  B = 1, N = 1,024 reads 28 KB and computes a
// few thousand operations, far under a microsecond at 3.35 TB/s; the fixed
// cost of a launch (about 1.1 us, chip_smoke.py's floor) and the one thread's
// dependent chain of f64 operations in the factorisation are the time.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SWEEPS = 8;          // one-sided Jacobi sweeps over the 3 pairs

// Sums each of the NV values over the block; every thread gets the totals.
// Warp shuffles in a fixed order, then warp partials added in warp order.
template <int NV>
__device__ void block_sum(double (&v)[NV], double* part, double* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        double x = v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) part[k * WARPS + warp] = x;
    }
    __syncthreads();
    if (threadIdx.x < NV) {
        double s = 0.0;
        for (int w = 0; w < WARPS; ++w) s += part[threadIdx.x * WARPS + w];
        total[threadIdx.x] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = total[k];
}

__device__ double dot3(const double* a, const double* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ void swap_cols(double (&m)[3][3], int p, int q) {
    for (int r = 0; r < 3; ++r) {
        const double x = m[p][r];
        m[p][r] = m[q][r];
        m[q][r] = x;
    }
}

// a[c] is column c of H; on return a[c] = sigma_c u_c (sorted descending)
// and v[c] is column c of V.
__device__ void jacobi_svd(double (&a)[3][3], double (&v)[3][3],
                           double (&sigma)[3]) {
    for (int c = 0; c < 3; ++c)
        for (int r = 0; r < 3; ++r) v[c][r] = (r == c) ? 1.0 : 0.0;
    for (int sweep = 0; sweep < SWEEPS; ++sweep) {
        for (int pair = 0; pair < 3; ++pair) {
            const int p = pair == 2 ? 1 : 0;
            const int q = pair == 0 ? 1 : 2;
            const double alpha = dot3(a[p], a[p]);
            const double beta = dot3(a[q], a[q]);
            const double gamma = dot3(a[p], a[q]);
            // converged (or an exact zero column): no rotation
            if (!(fabs(gamma) > 1e-300) ||
                fabs(gamma) <= 1e-17 * sqrt(alpha * beta))
                continue;
            const double zeta = (beta - alpha) / (2.0 * gamma);
            const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                             (fabs(zeta) + hypot(1.0, zeta));
            const double c = 1.0 / sqrt(1.0 + t * t);
            const double s = c * t;
            for (int r = 0; r < 3; ++r) {
                const double ap = a[p][r], aq = a[q][r];
                a[p][r] = c * ap - s * aq;
                a[q][r] = s * ap + c * aq;
                const double vp = v[p][r], vq = v[q][r];
                v[p][r] = c * vp - s * vq;
                v[q][r] = s * vp + c * vq;
            }
        }
    }
    for (int c = 0; c < 3; ++c) sigma[c] = sqrt(dot3(a[c], a[c]));
    // sort descending; equal values keep their order (H = 0 keeps V = I)
    for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2 - i; ++j)
            if (sigma[j + 1] > sigma[j]) {
                const double x = sigma[j];
                sigma[j] = sigma[j + 1];
                sigma[j + 1] = x;
                swap_cols(a, j, j + 1);
                swap_cols(v, j, j + 1);
            }
}

__device__ void normalize3(double* x) {
    const double n = sqrt(dot3(x, x));
    for (int r = 0; r < 3; ++r) x[r] /= n;
}

__device__ void cross3(const double* a, const double* b, double* out) {
    out[0] = a[1] * b[2] - a[2] * b[1];
    out[1] = a[2] * b[0] - a[0] * b[2];
    out[2] = a[0] * b[1] - a[1] * b[0];
}

// Proper orthonormal U from the rotated columns a[c] = sigma_c u_c.
__device__ void left_vectors(const double (&a)[3][3], const double (&sigma)[3],
                             double (&u)[3][3]) {
    if (!(sigma[0] > 0.0)) {                       // H = 0: U = I
        for (int c = 0; c < 3; ++c)
            for (int r = 0; r < 3; ++r) u[c][r] = (r == c) ? 1.0 : 0.0;
        return;
    }
    for (int r = 0; r < 3; ++r) u[0][r] = a[0][r] / sigma[0];
    normalize3(u[0]);
    bool have_u1 = sigma[1] > 1e-14 * sigma[0];
    if (have_u1) {
        const double d = dot3(a[1], u[0]);
        for (int r = 0; r < 3; ++r) u[1][r] = a[1][r] - d * u[0][r];
        have_u1 = dot3(u[1], u[1]) > 1e-28 * sigma[1] * sigma[1];
    }
    if (!have_u1) {
        // rank 1: any unit vector orthogonal to u0, from the axis least
        // aligned with it
        int k = 0;
        for (int r = 1; r < 3; ++r)
            if (fabs(u[0][r]) < fabs(u[0][k])) k = r;
        for (int r = 0; r < 3; ++r) u[1][r] = ((r == k) ? 1.0 : 0.0) - u[0][k] * u[0][r];
    }
    normalize3(u[1]);
    cross3(u[0], u[1], u[2]);
}

__global__ void __launch_bounds__(THREADS)
rigid_fit_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 const float* __restrict__ weights, float* __restrict__ out,
                 int n) {
    __shared__ double part[9 * WARPS];
    __shared__ double total[9];
    __shared__ double part2[9 * WARPS];
    __shared__ double total2[9];
    const long long b = blockIdx.x;
    const float* s = src + b * n * 3;
    const float* d = dst + b * n * 3;
    const float* w = weights ? weights + b * n : nullptr;

    // pass 1: weight sum and weighted sums of the points
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

    // pass 2: the centred correlation H[i][j] = sum w s_i d_j
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

    double a[3][3], v[3][3], u[3][3], sigma[3];
    for (int c = 0; c < 3; ++c)
        for (int r = 0; r < 3; ++r) a[c][r] = h[3 * r + c];   // column c of H
    jacobi_svd(a, v, sigma);
    left_vectors(a, sigma, u);
    // det(V U^T) = det(V), since U is proper
    double vc[3];
    cross3(v[0], v[1], vc);
    const double flip = dot3(vc, v[2]) >= 0.0 ? 1.0 : -1.0;
    double R[3][3];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            R[i][j] = v[0][i] * u[0][j] + v[1][i] * u[1][j] +
                      flip * v[2][i] * u[2][j];
    float* o = out + b * 16;
    for (int i = 0; i < 3; ++i) {
        const double t = mu_d[i] - (R[i][0] * mu_s[0] + R[i][1] * mu_s[1] +
                                    R[i][2] * mu_s[2]);
        for (int j = 0; j < 3; ++j) o[4 * i + j] = (float)R[i][j];
        o[4 * i + 3] = (float)t;
    }
    o[12] = 0.0f;
    o[13] = 0.0f;
    o[14] = 0.0f;
    o[15] = 1.0f;
}

}  // namespace

// weights may be null (every weight 1).  Returns the launch's cudaError.
extern "C" int rigid_fit_launch(const float* src, const float* dst,
                                const float* weights, float* out, int batch,
                                int n, void* stream) {
    if (batch < 0 || n < 0 || (long long)batch * n * 3 >= (1LL << 40))
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    rigid_fit_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        src, dst, weights, out, n);
    return static_cast<int>(cudaGetLastError());
}
