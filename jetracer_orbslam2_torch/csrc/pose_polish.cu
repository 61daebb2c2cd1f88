// Motion-only reprojection polish for sm_90a, K6: B problems of K points,
// each `iters` Gauss-Newton steps on a pose T (dst <- src) in ONE launch.
//   T0 (B, 4, 4), X_src (B, K, 3), uv_dst (B, K, 2), z_dst (B, K), w (B, K)
//   and intrinsics (4,) fx fy cx cy, all f32 on the card -> T (B, 4, 4) f32.
// Each step, as jetracer_orbslam2_tpu/models/tracking.py:59-105
// (refine_pose_reprojection) computes it:
//   p = T X (f32); iz = 1 / max(z, 1e-6); r = (fx x iz + cx - u,
//   fy y iz + cy - v, wz (z - z_dst)), wz = fx / max(z_dst, 0.1) where
//   z_dst > 1e-3, else 0;
//   wk = w [z > 1e-3] min(1, huber / max(|r|, 1e-9));
//   J = J_proj [I | -hat(p)] (3 x 6 a point);
//   H = sum wk J^T J + 1e-6 I, b = -sum wk J^T r; dx = H^-1 b;
//   T <- se3_exp(dx) T.
//
// Replaces no TPU kernel: the JAX package runs this as one lax.scan of the
// steps inside its jitted frame step, which XLA compiles into a few fused
// kernels.  The port's plain version (ops/fused_polish.pose_polish_reference)
// is about 515 small PyTorch kernels a call (five steps of projections,
// stacks, einsums, an LU solve and se3_exp), the longest chain of a graphed
// odometry frame and run twice in a SLAM frame (the tracker's polish and the
// map polish).  This kernel is that whole chain as one node.
//
// What bounds it: not bytes (B 1, K 1,024 reads 28 KB) nor operations
// (about 0.8 MFLOP), but latency: a launch, then `iters` times a pass over
// the points, a block-wide reduction of 27 sums and one thread's 6 x 6
// factorisation, each step waiting for the one before.  So the design keeps
// each step inside one block:
//   - one block of 256 threads a problem; T lives in shared memory between
//     steps, behind a barrier;
//   - K <= REG_POINTS (1,024): each thread loads its points once into
//     registers (4 a thread); a larger K is read from global memory on every
//     step (the problem is 28 B a point and stays in L2).  There is no cap
//     on K.  Thread i takes points i, i + 256, ... on both paths, in the
//     same order, so they give the same bits.  The register path is kept
//     because it is faster where the frame step runs: at B 1, K 1,024 on an
//     H100 80GB HBM3 (700 W) a launch takes 16.8 us with the points in
//     registers and 18.4 us with them read on every step (chip_smoke.py
//     phase 23 times both and checks that their bits agree);
//   - per point the residual, the Huber weight and the Jacobian in f32, as
//     the plain version computes them; the 21 upper entries of H and the 6
//     of b accumulated in f64 in a fixed point order; then a warp
//     reduce-scatter of the 27 sums (padded to 32: 31 shuffles a lane, lane
//     l ending with sum l), and warp 0 adds the eight warps' partials in
//     warp order.  No atomics: a relaunch and a graph replay repeat bit for
//     bit;
//   - one thread: Cholesky of H in f64 (one rsqrt a column, no division)
//     and a forward and back solve (the plain version's LU,
//     torch.linalg.solve_ex).  H = J^T W J + 1e-6 I is
//     positive definite; where a pivot is not positive (rounding, NaN) the
//     step is dx = 0 and is counted in `singular` when asked;
//   - se3_exp(dx) and the product exp(dx) T in f32, with
//     ops/geometry.py's guards (the theta^2 < 1e-8 Taylor branches).
//
// Reads the intrinsics from device memory (no host read, so a CUDA graph can
// capture the launch).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 4;                         // points in registers
constexpr int REG_POINTS = THREADS * PER_THREAD;      // 1,024
constexpr int NH = 21;                                // upper entries of H
constexpr int NSUM = NH + 6;                          // and b
constexpr int NSLOT = 32;                             // padded to a warp
constexpr unsigned FULL = 0xffffffffu;
static_assert(NSUM <= NSLOT, "the 27 sums fit one warp's reduce-scatter");

// One point's measurements: X_src, uv_dst, z_dst, w, and the depth row's
// weight wz.
struct Point {
    float x, y, z, u, v, zd, w, wz;
};

__device__ __forceinline__ Point load_point(const float* __restrict__ X,
                                            const float* __restrict__ uv,
                                            const float* __restrict__ zd,
                                            const float* __restrict__ w, int i,
                                            float fx) {
    Point q;
    q.x = X[3 * i];
    q.y = X[3 * i + 1];
    q.z = X[3 * i + 2];
    q.u = uv[2 * i];
    q.v = uv[2 * i + 1];
    q.zd = zd[i];
    q.w = w[i];
    q.wz = q.zd > 1e-3f ? fx / fmaxf(q.zd, 0.1f) : 0.0f;
    return q;
}

struct Camera {
    float fx, fy, cx, cy;
};

// s += one point's terms at pose T (rows 0-2 of a row-major 4 x 4): the 21
// upper entries of wk J^T J (row-major order, i <= j) in s[0..20] and
// wk J^T r in s[21..26].
__device__ __forceinline__ void accumulate(double (&s)[NSLOT], const Point& q,
                                           const float (&T)[12], const Camera& c,
                                           float huber) {
    const float px = q.x * T[0] + q.y * T[1] + q.z * T[2] + T[3];
    const float py = q.x * T[4] + q.y * T[5] + q.z * T[6] + T[7];
    const float pz = q.x * T[8] + q.y * T[9] + q.z * T[10] + T[11];
    const float iz = 1.0f / fmaxf(pz, 1e-6f);
    const float u = c.fx * px * iz + c.cx;
    const float v = c.fy * py * iz + c.cy;
    const float r[3] = {u - q.u, v - q.v, q.wz * (pz - q.zd)};
    float wk = q.w * (pz > 1e-3f ? 1.0f : 0.0f);
    const float nrm = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
    wk = wk * fminf(huber / fmaxf(nrm, 1e-9f), 1.0f);
    // J_proj rows (a00, 0, a02), (0, a11, a12), (0, 0, wz) times
    // [I | -hat(p)], -hat(p) having columns (0, -z, y), (z, 0, -x), (-y, x, 0)
    const float a00 = c.fx * iz, a02 = -c.fx * px * iz * iz;
    const float a11 = c.fy * iz, a12 = -c.fy * py * iz * iz;
    const float J[3][6] = {
        {a00, 0.0f, a02, a02 * py, a00 * pz - a02 * px, -a00 * py},
        {0.0f, a11, a12, a12 * py - a11 * pz, -a12 * px, a11 * px},
        {0.0f, 0.0f, q.wz, q.wz * py, -q.wz * px, 0.0f}};
    // the f64 work skips J's five entries that are zero by construction
    // (their products would add exact zeros): 36 + 13 multiply-adds a
    // point, not 63 + 18
    constexpr bool nz[3][6] = {{true, false, true, true, true, true},
                               {false, true, true, true, true, true},
                               {false, false, true, true, true, false}};
    const double wd = wk;
#pragma unroll
    for (int row = 0; row < 3; ++row) {
        double wj[6], jd[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            jd[i] = nz[row][i] ? (double)J[row][i] : 0.0;
            wj[i] = nz[row][i] ? wd * jd[i] : 0.0;
        }
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = i; j < 6; ++j, ++k)
                if (nz[row][i] && nz[row][j]) s[k] = fma(wj[i], jd[j], s[k]);
        const double rr = r[row];
#pragma unroll
        for (int i = 0; i < 6; ++i)
            if (nz[row][i]) s[NH + i] = fma(wj[i], rr, s[NH + i]);
    }
}

// One halving step of the warp's reduce-scatter over 2 C values: lanes with
// bit C set keep the upper C, the others the lower C, each adding its
// partner's (lane ^ C) copy of the half it keeps.  After C = 16, 8, 4, 2, 1
// lane l holds the warp's sum of slot l.
template <int C>
__device__ __forceinline__ void fold(double (&v)[NSLOT], int lane) {
    const bool upper = (lane & C) != 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        const double send = upper ? v[j] : v[j + C];
        const double keep = upper ? v[j + C] : v[j];
        v[j] = keep + __shfl_xor_sync(FULL, send, C);
    }
}

// dx = H^-1 b by Cholesky in f64 (H from the 21 upper entries, 1e-6 added
// on the diagonal; b = -sums[21..26]).  One reciprocal square root a column
// (inv[j] = 1 / L[j][j]); every other step of the factorisation and of the
// two solves is a multiply-add, so the one thread's dependent chain holds
// six rsqrt and no division.  Returns false, dx = 0, when a pivot is not
// positive.
__device__ bool cholesky_solve(const double* sums, double (&dx)[6]) {
    double L[6][6], inv[6];
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j, ++k) L[j][i] = sums[k];   // lower = H
#pragma unroll
    for (int i = 0; i < 6; ++i) L[i][i] += 1e-6;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
        double d = L[j][j];
#pragma unroll
        for (int m = 0; m < j; ++m) d -= L[j][m] * L[j][m];
        if (!(d > 0.0)) {
#pragma unroll
            for (int i = 0; i < 6; ++i) dx[i] = 0.0;
            return false;
        }
        inv[j] = rsqrt(d);
#pragma unroll
        for (int i = j + 1; i < 6; ++i) {
            double e = L[i][j];
#pragma unroll
            for (int m = 0; m < j; ++m) e -= L[i][m] * L[j][m];
            L[i][j] = e * inv[j];
        }
    }
    double y[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        double e = -sums[NH + i];
#pragma unroll
        for (int m = 0; m < i; ++m) e -= L[i][m] * y[m];
        y[i] = e * inv[i];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
        double e = y[i];
#pragma unroll
        for (int m = i + 1; m < 6; ++m) e -= L[m][i] * dx[m];
        dx[i] = e * inv[i];
    }
    return true;
}

// T <- se3_exp(xi) T in f32 (T row-major 4 x 4; its last row is kept, as
// the plain version's product with exp's (0, 0, 0, 1) row keeps it), with
// geometry.se3_exp's guards.
__device__ void exp_update(const float (&xi)[6], float* T) {
    const float v[3] = {xi[0], xi[1], xi[2]};
    const float w[3] = {xi[3], xi[4], xi[5]};
    const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const float theta = sqrtf(theta2);
    const bool small = theta2 < 1e-8f;
    const float A = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
    const float B = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
    const float C = small ? 1.0f / 6.0f - theta2 / 120.0f : (1.0f - A) / theta2;
    const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
    float W2[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
    float E[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float eye = i == j ? 1.0f : 0.0f;
            E[i][j] = eye + A * W[i][j] + B * W2[i][j];
        }
        float t = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float eye = i == j ? 1.0f : 0.0f;
            t += (eye + B * W[i][j] + C * W2[i][j]) * v[j];
        }
        E[i][3] = t;
    }
    float out[12];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            out[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                             E[i][3] * T[12 + j];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = out[k];
}

// kRegs: K <= REG_POINTS, each thread's points held in registers; otherwise
// read from global memory on every step.
template <bool kRegs>
__global__ void __launch_bounds__(THREADS)
pose_polish_kernel(const float* __restrict__ T0, const float* __restrict__ X,
                   const float* __restrict__ uv, const float* __restrict__ zd,
                   const float* __restrict__ w, const float* __restrict__ intr,
                   float* __restrict__ out, int* __restrict__ singular, int k,
                   int iters, float huber) {
    __shared__ double part[WARPS * NSLOT];
    __shared__ double sums[NSLOT];
    __shared__ float Ts[16];
    const long long b = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Camera cam = {intr[0], intr[1], intr[2], intr[3]};
    const float* Xb = X + b * 3 * k;
    const float* uvb = uv + b * 2 * k;
    const float* zdb = zd + b * k;
    const float* wb = w + b * k;
    if (threadIdx.x < 16) Ts[threadIdx.x] = T0[b * 16 + threadIdx.x];
    Point held[kRegs ? PER_THREAD : 1];
    if (kRegs) {
#pragma unroll
        for (int p = 0; p < PER_THREAD; ++p) {
            const int i = threadIdx.x + p * THREADS;
            if (i < k) held[p] = load_point(Xb, uvb, zdb, wb, i, cam.fx);
        }
    }
    int bad = 0;
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
        float T[12];
#pragma unroll
        for (int m = 0; m < 12; ++m) T[m] = Ts[m];
        double s[NSLOT];
#pragma unroll
        for (int m = 0; m < NSLOT; ++m) s[m] = 0.0;
        if (kRegs) {
#pragma unroll
            for (int p = 0; p < PER_THREAD; ++p)
                if (threadIdx.x + p * THREADS < k) accumulate(s, held[p], T, cam, huber);
        } else {
            for (int i = threadIdx.x; i < k; i += THREADS)
                accumulate(s, load_point(Xb, uvb, zdb, wb, i, cam.fx), T, cam, huber);
        }
        fold<16>(s, lane);
        fold<8>(s, lane);
        fold<4>(s, lane);
        fold<2>(s, lane);
        fold<1>(s, lane);
        part[warp * NSLOT + lane] = s[0];
        __syncthreads();
        if (warp == 0) {
            double total = part[lane];
            for (int m = 1; m < WARPS; ++m) total += part[m * NSLOT + lane];
            sums[lane] = total;
            __syncwarp();
            if (lane == 0) {
                double dx[6];
                bad += !cholesky_solve(sums, dx);
                float xi[6];
                for (int m = 0; m < 6; ++m) xi[m] = (float)dx[m];
                exp_update(xi, Ts);
            }
        }
        __syncthreads();
    }
    if (threadIdx.x < 16) out[b * 16 + threadIdx.x] = Ts[threadIdx.x];
    if (threadIdx.x == 0 && singular) singular[b] = bad;
}

}  // namespace

// T0 (B, 4, 4), X (B, K, 3), uv (B, K, 2), zd (B, K), w (B, K), intr (4,)
// -> out (B, 4, 4), all f32 on the card; singular (B,) int32 or null: the
// steps whose Cholesky met a pivot that was not positive.  Any K.  Returns
// the launch's cudaError.
extern "C" int pose_polish_launch(const float* T0, const float* X, const float* uv,
                                  const float* zd, const float* w,
                                  const float* intr, float* out, int* singular,
                                  int batch, int k, int iters, float huber,
                                  void* stream) {
    if (batch < 0 || k < 0 || k > 0x7fffffff / 3 || iters < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k <= REG_POINTS)
        pose_polish_kernel<true><<<batch, THREADS, 0, s>>>(
            T0, X, uv, zd, w, intr, out, singular, k, iters, huber);
    else
        pose_polish_kernel<false><<<batch, THREADS, 0, s>>>(
            T0, X, uv, zd, w, intr, out, singular, k, iters, huber);
    return static_cast<int>(cudaGetLastError());
}
