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
// stacks, einsums, an LU solve and se3_exp), run once in an odometry frame
// and twice in a SLAM frame (the tracker's polish and the map polish).  This
// kernel is that whole chain as one node.
//
// What bounds it: not bytes (B 1, K 1,024 reads 28 KB) nor operations
// (about 0.9 MFLOP), but latency: a launch, then `iters` times a pass over
// the points, a reduction of 27 sums and a 6 x 6 factorisation, each step
// waiting for the one before.  So the design shortens each step
// (scripts/bench_torch_k6.py splits a step into its parts):
//   - a problem is split over a thread-block cluster of CTAS blocks of 128
//     threads (CTAS from K: one block a 128 points, in powers of two up to
//     8), so the pass over the points runs on CTAS SMs; thread g of the
//     problem's CTAS x 128 takes points g, g + CTAS x 128, ... in that order
//     on every path;
//   - a thread's points are held in registers for all the steps, in a
//     kernel with room for one (K up to 1,024) or for PER_THREAD (K up to
//     8,192); a larger K is read from global memory on every step (it stays
//     in L2), in the same order, so every path gives the same bits.  The
//     kernel with room for one has fewer registers (128 against 196) and
//     is faster at K 1,024 than the one with room for 8 (chip_smoke.py
//     phase 23 times the paths and the cluster sizes through a harness
//     that includes this file);
//   - per point the residual, the Huber weight and the Jacobian in f32, as
//     the plain version computes them, and the 21 upper entries of H and
//     the 6 of b summed in f32 over the thread's own points (the plain
//     version sums all of them in f32); a warp reduce-scatter of the 27 f32
//     sums (31 shuffles a lane, lane l ending with sum l), each lane's sum
//     converted to f64 once;
//   - no barrier across the cluster in a step: every warp stores its 27
//     partials into every block's shared memory of the cluster with
//     st.async (double-buffered by step parity), and every warp waits on
//     its block's mbarrier for exactly the bytes of the step
//     (csrc/cluster.cuh); a block reaches step s + 2's stores only after
//     every warp of the cluster stored step s + 1's, so no buffer is
//     written while it is read.  Every warp then adds the CTAS x 4 partials
//     in f64 in one fixed order (a block's four pairwise, then block after
//     block), broadcasts them by shuffle, solves and moves T: every thread
//     of the cluster holds the same T in registers, bit for bit.  No
//     atomics: a relaunch and a graph replay repeat bit for bit;
//   - dx = H^-1 b in f64 by H's 3 x 3 blocks (A^-1 and the Schur
//     complement's inverse in closed form: a dependent chain of about 30
//     multiply-adds and two reciprocals, where a Cholesky's holds six
//     reciprocal square roots and twice the multiply-adds); the plain
//     version solves by LU (torch.linalg.solve_ex).  H = J^T W J + 1e-6 I
//     is positive definite; where one of its six leading minors is not
//     positive (rounding, NaN) the step is dx = 0 and is counted in
//     `singular` when asked;
//   - se3_exp(dx) and the product exp(dx) T in f32, with ops/geometry.py's
//     guards (the theta^2 < 1e-8 Taylor branches), sin and cos by one
//     sincosf.
//
// Reads the intrinsics from device memory (no host read, so a CUDA graph can
// capture the launch).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 8;                         // at most, in registers
constexpr int MAX_CTAS = 8;                           // a portable cluster
constexpr int NH = 21;                                // upper entries of H
constexpr int NSUM = NH + 6;                          // and b
constexpr int NSLOT = 32;                             // padded to a warp
constexpr unsigned FULL = 0xffffffffu;
static_assert(NSUM <= NSLOT, "the 27 sums fit one warp's reduce-scatter");
static_assert(WARPS == 4, "a block's partials are added as four");

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

// s += one point's terms at pose T (row-major 4 x 4): the 21 upper entries
// of wk J^T J (row-major order, i <= j) in s[0..20] and wk J^T r in
// s[21..26], in f32.
__device__ __forceinline__ void accumulate(float (&s)[NSLOT], const Point& q,
                                           const float (&T)[16], const Camera& c,
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
    // J's five entries that are zero by construction are skipped (their
    // products would add exact zeros): 36 + 13 multiply-adds a point
    constexpr bool nz[3][6] = {{true, false, true, true, true, true},
                               {false, true, true, true, true, true},
                               {false, false, true, true, true, false}};
#pragma unroll
    for (int row = 0; row < 3; ++row) {
        float wj[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) wj[i] = nz[row][i] ? wk * J[row][i] : 0.0f;
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = i; j < 6; ++j, ++k)
                if (nz[row][i] && nz[row][j]) s[k] = fmaf(wj[i], J[row][j], s[k]);
#pragma unroll
        for (int i = 0; i < 6; ++i)
            if (nz[row][i]) s[NH + i] = fmaf(wj[i], r[row], s[NH + i]);
    }
}

// One halving step of the warp's reduce-scatter over 2 C values: lanes with
// bit C set keep the upper C, the others the lower C, each adding its
// partner's (lane ^ C) copy of the half it keeps.  After C = 16, 8, 4, 2, 1
// lane l holds the warp's sum of slot l.
template <int C>
__device__ __forceinline__ void fold(float (&v)[NSLOT], int lane) {
    const bool upper = (lane & C) != 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        const float send = upper ? v[j] : v[j + C];
        const float keep = upper ? v[j + C] : v[j];
        v[j] = keep + __shfl_xor_sync(FULL, send, C);
    }
}

// The warp's reduce-scatter of the 32 slots: lane l ends with slot l's sum.
__device__ __forceinline__ void reduce_scatter(float (&s)[NSLOT], int lane) {
    fold<16>(s, lane);
    fold<8>(s, lane);
    fold<4>(s, lane);
    fold<2>(s, lane);
    fold<1>(s, lane);
}

// The inverse of a symmetric 3 x 3 m by its adjugate (m's determinant in
// `det`, m[0][0] and its leading 2 x 2 minor in `d1`, `d2`: m is positive
// definite when all three are positive).
__device__ __forceinline__ void inverse3(const double (&m)[3][3], double (&r)[3][3],
                                        double& d1, double& d2, double& det) {
    const double c00 = m[1][1] * m[2][2] - m[1][2] * m[1][2];
    const double c01 = m[1][2] * m[0][2] - m[0][1] * m[2][2];
    const double c02 = m[0][1] * m[1][2] - m[1][1] * m[0][2];
    const double c11 = m[0][0] * m[2][2] - m[0][2] * m[0][2];
    const double c12 = m[0][1] * m[0][2] - m[0][0] * m[1][2];
    const double c22 = m[0][0] * m[1][1] - m[0][1] * m[0][1];
    d1 = m[0][0];
    d2 = c22;
    det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02;
    const double inv = 1.0 / det;
    r[0][0] = c00 * inv;
    r[0][1] = r[1][0] = c01 * inv;
    r[0][2] = r[2][0] = c02 * inv;
    r[1][1] = c11 * inv;
    r[1][2] = r[2][1] = c12 * inv;
    r[2][2] = c22 * inv;
}

// dx = H^-1 b in f64 (H from the 21 upper entries, 1e-6 added on the
// diagonal; b = -sums[21..26]) by its 3 x 3 blocks H = [A B; B^T D]: A^-1
// and the Schur complement S = D - B^T A^-1 B inverted in closed form, then
// dx2 = S^-1 (b2 - B^T A^-1 b1), dx1 = A^-1 (b1 - B dx2).  Its dependent
// chain is about 30 multiply-adds and two reciprocals (a Cholesky's is six
// reciprocal square roots and twice as many multiply-adds).  H is positive
// definite exactly when its six leading minors are positive (Sylvester):
// those of A, then det(A) times those of S.  Where one is not (rounding,
// NaN) the step is dx = 0 and false is returned.
__device__ __forceinline__ bool block_solve(const double (&sums)[NSUM], double (&dx)[6]) {
    double H[6][6];
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j, ++k) H[i][j] = H[j][i] = sums[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) H[i][i] += 1e-6;
    double A[3][3], B[3][3], D[3][3], b1[3], b2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            A[i][j] = H[i][j];
            B[i][j] = H[i][3 + j];
            D[i][j] = H[3 + i][3 + j];
        }
        b1[i] = -sums[NH + i];
        b2[i] = -sums[NH + 3 + i];
    }
    double Ai[3][3], a1, a2, a3;
    inverse3(A, Ai, a1, a2, a3);
    double G[3][3], y1[3];                   // G = A^-1 B, y1 = A^-1 b1
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        y1[i] = Ai[i][0] * b1[0] + Ai[i][1] * b1[1] + Ai[i][2] * b1[2];
#pragma unroll
        for (int j = 0; j < 3; ++j)
            G[i][j] = Ai[i][0] * B[0][j] + Ai[i][1] * B[1][j] + Ai[i][2] * B[2][j];
    }
    double S[3][3], r2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        r2[i] = b2[i] - (B[0][i] * y1[0] + B[1][i] * y1[1] + B[2][i] * y1[2]);
#pragma unroll
        for (int j = 0; j < 3; ++j)
            S[i][j] = D[i][j] - (B[0][i] * G[0][j] + B[1][i] * G[1][j] + B[2][i] * G[2][j]);
    }
    double Si[3][3], s1, s2, s3;
    inverse3(S, Si, s1, s2, s3);
    const bool ok = a1 > 0.0 && a2 > 0.0 && a3 > 0.0 && s1 > 0.0 && s2 > 0.0 && s3 > 0.0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
        dx[3 + i] = Si[i][0] * r2[0] + Si[i][1] * r2[1] + Si[i][2] * r2[2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
        dx[i] = y1[i] - (G[i][0] * dx[3] + G[i][1] * dx[4] + G[i][2] * dx[5]);
    if (!ok) {
#pragma unroll
        for (int i = 0; i < 6; ++i) dx[i] = 0.0;
    }
    return ok;
}

// T <- se3_exp(xi) T in f32 (T row-major 4 x 4; its last row is kept, as
// the plain version's product with exp's (0, 0, 0, 1) row keeps it), with
// geometry.se3_exp's guards.
__device__ __forceinline__ void exp_update(const float (&xi)[6], float (&T)[16]) {
    const float v[3] = {xi[0], xi[1], xi[2]};
    const float w[3] = {xi[3], xi[4], xi[5]};
    const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const float theta = sqrtf(theta2);
    const bool small = theta2 < 1e-8f;
    float sn, cs;
    sincosf(theta, &sn, &cs);
    const float A = small ? 1.0f - theta2 / 6.0f : sn / theta;
    const float B = small ? 0.5f - theta2 / 24.0f : (1.0f - cs) / theta2;
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

// Step `it`'s partials of this warp (this lane's slot, `mine`) into every
// block of the cluster by st.async against each block's mbarrier (into this
// block's shared memory when there is no cluster: ctas 1, made visible by
// the caller's block barrier).  The buffers alternate by step parity.
// Before step 0 the caller has set up the mbarriers and arrived on the
// cluster barrier.
__device__ __forceinline__ void exchange_send(double mine,
                                              double (*part)[MAX_CTAS * WARPS][NSLOT],
                                              uint64_t* bar, int it, int rank, int ctas,
                                              int warp, int lane) {
    const int buf = it & 1;
    double (*slots)[NSLOT] = part[buf];
    if (ctas == 1) {
        slots[warp][lane] = mine;
        return;
    }
    if (it == 0) cluster_wait();              // every block runs, its barriers set
    if (lane < NSUM) {
        const unsigned at = smem_addr(&slots[rank * WARPS + warp][lane]);
        const unsigned on = smem_addr(&bar[buf]);
        for (int r = 0; r < ctas; ++r)
            st_async(cluster_addr(at, r), mine, cluster_addr(on, r));
    }
}

// Slot `lane` of step `it` added over every warp of the cluster in one fixed
// order (a block's four warps pairwise, then block after block; every load
// issued before the first add), once the step's partials are in: after the
// wait on this block's mbarrier (a cluster) or the caller's block barrier.
// Every warp of the block reads the step's buffer; a warp's next stores
// into it come two steps later, after every warp has sent the step between.
__device__ __forceinline__ double exchange_total(double (*part)[MAX_CTAS * WARPS][NSLOT],
                                                 uint64_t* bar, int it, int ctas, int lane) {
    const int buf = it & 1;
    if (ctas > 1) mbar_wait(&bar[buf], (it >> 1) & 1);
    double (*slots)[NSLOT] = part[buf];
    double block[MAX_CTAS];
#pragma unroll
    for (int r = 0; r < MAX_CTAS; ++r) {
        if (r < ctas) {
            const double* q = &slots[r * WARPS][lane];
            block[r] = (q[0] + q[NSLOT]) + (q[2 * NSLOT] + q[3 * NSLOT]);
        }
    }
    double total = block[0];
#pragma unroll
    for (int r = 1; r < MAX_CTAS; ++r)
        if (r < ctas) total += block[r];
    return total;
}

// Sets up a cluster's exchange before step 0 (ctas > 1): this block's two
// mbarriers, then its arrival on the cluster barrier that releases them.
__device__ __forceinline__ void exchange_setup(uint64_t* bar) {
    if (threadIdx.x == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        mbar_init_fence();
    }
    cluster_arrive();
}

// The bytes a block of a ctas-block cluster receives a step: 27 f64
// partials of every warp.  Thread 0 expects them before the step's stores.
__device__ __forceinline__ void exchange_expect(uint64_t* bar, int it, int ctas) {
    if (ctas > 1 && threadIdx.x == 0)
        mbar_expect(&bar[it & 1], static_cast<unsigned>(ctas * WARPS * NSUM * 8));
}

// kPer > 0: each thread's points (at most kPer) held in registers; kPer 0:
// read from global memory on every step.  ctas: the cluster's size (1: a
// plain launch, no cluster).
template <int kPer>
__global__ void __launch_bounds__(THREADS)
pose_polish_kernel(const float* __restrict__ T0, const float* __restrict__ X,
                   const float* __restrict__ uv, const float* __restrict__ zd,
                   const float* __restrict__ w, const float* __restrict__ intr,
                   float* __restrict__ out, int* __restrict__ singular, int k,
                   int iters, float huber, int ctas) {
    // partials of step parity p from block r's warp m: part[p][r * WARPS + m]
    __shared__ double part[2][MAX_CTAS * WARPS][NSLOT];
    __shared__ uint64_t bar[2];
    const int rank = ctas > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
    const long long b = blockIdx.x / ctas;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = rank * THREADS + threadIdx.x, stride = ctas * THREADS;
    const Camera cam = {intr[0], intr[1], intr[2], intr[3]};
    const float* Xb = X + b * 3 * k;
    const float* uvb = uv + b * 2 * k;
    const float* zdb = zd + b * k;
    const float* wb = w + b * k;
    float T[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) T[m] = T0[b * 16 + m];
    constexpr bool kRegs = kPer > 0;
    Point held[kRegs ? kPer : 1];
    if (kRegs) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
            const int i = g + p * stride;
            if (i < k) held[p] = load_point(Xb, uvb, zdb, wb, i, cam.fx);
        }
    }
    if (ctas > 1 && iters > 0) exchange_setup(bar);
    int bad = 0;

    for (int it = 0; it < iters; ++it) {
        exchange_expect(bar, it, ctas);
        float s[NSLOT];
#pragma unroll
        for (int m = 0; m < NSLOT; ++m) s[m] = 0.0f;
        if (kRegs) {
#pragma unroll
            for (int p = 0; p < kPer; ++p)
                if (g + p * stride < k) accumulate(s, held[p], T, cam, huber);
        } else {
            for (int i = g; i < k; i += stride)
                accumulate(s, load_point(Xb, uvb, zdb, wb, i, cam.fx), T, cam, huber);
        }
        reduce_scatter(s, lane);
        exchange_send(static_cast<double>(s[0]), part, bar, it, rank, ctas, warp, lane);
        if (ctas == 1) __syncthreads();
        // every warp adds the partials, solves and moves T alike (a block's
        // four warps run on its four schedulers, so the redundant f64 work
        // shares no pipe; on an H100 this beat warp 0 solving and handing T
        // on behind a block barrier)
        const double total = exchange_total(part, bar, it, ctas, lane);
        double sums[NSUM];
#pragma unroll
        for (int m = 0; m < NSUM; ++m) sums[m] = __shfl_sync(FULL, total, m);
        double dx[6];
        bad += !block_solve(sums, dx);
        float xi[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) xi[m] = static_cast<float>(dx[m]);
        exp_update(xi, T);
    }
    if (rank == 0 && threadIdx.x == 0) {
#pragma unroll
        for (int m = 0; m < 16; ++m) out[b * 16 + m] = T[m];
        if (singular) singular[b] = bad;
    }
}

// The cluster's size for K points: one block a 128 points (a point a
// thread), in powers of two up to MAX_CTAS.
int ctas_for(int k) {
    int c = 1;
    while (c < MAX_CTAS && c * THREADS < k) c *= 2;
    return c;
}

// B problems on a cluster of `ctas` blocks each (1: a plain launch), a
// thread's points in registers with room for kPer (0: read from memory on
// every step; the caller sees that kPer x ctas x THREADS >= K).
template <int kPer>
cudaError_t launch(const float* T0, const float* X, const float* uv,
                   const float* zd, const float* w, const float* intr, float* out,
                   int* singular, int batch, int k, int iters, float huber,
                   int ctas, cudaStream_t s) {
    if (ctas == 1) {
        pose_polish_kernel<kPer><<<batch, THREADS, 0, s>>>(
            T0, X, uv, zd, w, intr, out, singular, k, iters, huber, 1);
        return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(batch) * static_cast<unsigned>(ctas));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, pose_polish_kernel<kPer>, T0, X, uv, zd, w,
                              intr, out, singular, k, iters, huber, ctas);
}

}  // namespace

// T0 (B, 4, 4), X (B, K, 3), uv (B, K, 2), zd (B, K), w (B, K), intr (4,)
// -> out (B, 4, 4), all f32 on the card; singular (B,) int32 or null: the
// steps whose H was not positive definite (dx = 0 there).  Any K: the
// cluster's size from K; a thread's points in a kernel with room for one
// (K up to 1,024, the main path's) or PER_THREAD, more read from memory on
// every step (the same bits).  Returns the launch's cudaError.
extern "C" int pose_polish_launch(const float* T0, const float* X, const float* uv,
                                  const float* zd, const float* w,
                                  const float* intr, float* out, int* singular,
                                  int batch, int k, int iters, float huber,
                                  void* stream) {
    if (batch < 0 || k < 0 || k > 0x7fffffff / 3 || iters < 0 ||
        batch > 0x7fffffff / MAX_CTAS)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    const int ctas = ctas_for(k);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k <= ctas * THREADS)
        err = launch<1>(T0, X, uv, zd, w, intr, out, singular, batch, k, iters, huber,
                        ctas, s);
    else if (k <= PER_THREAD * ctas * THREADS)
        err = launch<PER_THREAD>(T0, X, uv, zd, w, intr, out, singular, batch, k, iters,
                                 huber, ctas, s);
    else
        err = launch<0>(T0, X, uv, zd, w, intr, out, singular, batch, k, iters, huber,
                        ctas, s);
    return static_cast<int>(err);
}
