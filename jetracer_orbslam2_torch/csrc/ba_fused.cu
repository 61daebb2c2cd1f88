// Fused bundle-adjustment kernels for sm_90a: normal equations + Schur
// preparation (ba_assemble) and landmark back-substitution (ba_backsub).
//
// Replace the TPU kernels jetracer_orbslam2_tpu/ops/pallas_ba.py::
// fused_normal_schur and ::fused_backsub.  Same functions as the plain
// PyTorch versions beside the wrappers (ops/fused_ba.py), which are built
// from models/backend/ba.py: dense_normal_equations + the pieces of
// _solve_schur.  No Jacobian is ever written to device memory.
//
// Inputs (all f32, landmark axis last, so consecutive threads read
// consecutive addresses):
//   poses  (P, 12)   [R row-major | t] of T_cw
//   points (3, L)    world positions
//   obs    (5, P, L) [u, v, z, z_valid, w]
//   free   (L,)      1 = landmark is optimised, 0 = frozen
//   scal   (8,)      [fx, fy, cx, cy, lambda, huber, 0, 0] (device memory:
//                    lambda is the LM carry and never visits the host)
//
// ba_assemble outputs: Hpp (P,6,6), S = Gh G^T (6P,6P) in pose-major order
// (row p*6+i), bp (P,6), rhs = Gh bl (P,6), Hll^-1 (9,L), bl (3,L).
// ba_backsub output: dxl (3,L) = free * Hll^-1 (bl - G^T dxp).
//
// Bound on this card.  ba_assemble is bound by operations: per landmark the
// Schur product costs 2*(6P)*(6P+1)*3 f32 operations (13.9 k at P = 8)
// against 4*(5P+16) bytes (224 B at P = 8).  ba_backsub is bound by bytes.
// At the sizes the system runs (L = 4,096 .. 16,384) both bounds lie below
// the cost of a launch.  What the design does: the only traffic is the
// inputs, (12, L) of outputs and one (P*42 + 6P*(6P+1))-float partial per
// block; everything else lives in registers and shared memory.
//
// Design of ba_assemble (not the TPU kernel's: that one puts 8 poses on the
// sublanes, a 1,024-landmark tile on the lanes and carries its sums from
// grid step to grid step in order).  One block of 256 threads owns LT
// consecutive landmarks, LT = 64 where that still gives every SM a block and
// 32 otherwise.  The threads form PG = 256 / LT pose groups: thread (g, l)
// loops over the poses p = g, g + PG, ... for landmark l.
//   pass 1   weighted residual and Jacobian planes per (p, l); Hll (6 unique
//            entries) and bl (3) accumulate in registers; the weighted Jp
//            rows and residuals are staged in shared memory.  The pose
//            groups' Hll/bl partials meet in shared memory and are added in
//            the order g = 0..PG-1 by every thread, then damping, the
//            identity for frozen landmarks and the symmetric adjugate inverse
//            follow in registers.  Hll^-1 and bl go to device memory.
//   Hpp, bp  each thread owns one of the P*27 sums (upper triangle of a 6x6
//            block + bp column per pose; only the diagonal blocks of Jp Jp^T
//            are needed) and loops over the 3*LT staged columns.
//   pass 2   G needs Hll^-1, which needs every pose, so the pose loop runs a
//            second time and RECOMPUTES the planes (about 150 operations per
//            slot) instead of keeping G (P*18 floats per thread: 144
//            registers at P = 8, 288 at P = 16, which would spill).  G and
//            Gh = G Hll^-1 are staged in shared memory, with bl as one more
//            row of G so that rhs = Gh bl is one more column of the product.
//   S        each thread owns 4x4 output tiles of the (6P) x (6P+1) product
//            and loops over the 3*LT staged columns: FP32 FMA, no tensor
//            cores (TF32 would break f32 parity with the dense route).
// Each block writes its partial sums to a workspace; ba_reduce_kernel adds
// the partials in an order that the shapes fix (warp w of a block adds the
// partials w, w+8, ... in turn, then the eight sums are added in order).  No
// float atomics anywhere, so two launches on the same inputs agree bit for
// bit.
//
// Shared memory: 3*LT*max(7P|1, 6P+1) + max(3*LT*(6P+1), 9*256) floats + the
// poses: 81.0 KB at P = 8 and 162.0 KB at P = 16 with LT = 64 (half of that
// with LT = 32), which is why MAX_POSES is 16 (the card allows a block
// 227 KB).  Any L >= 1: tail threads compute on zeros and store nothing.
//
// Arithmetic: IEEE division and square root (do not build with
// --use_fast_math); the compiler contracts a*b+c into FMAs, so sums differ
// from eager PyTorch in the last bits, and the order of the sums over
// landmarks differs too.  The comparison with the plain version therefore
// has a tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // ba_assemble: LT landmarks x PG pose groups
constexpr int S_UNROLL = 4;         // staged columns per step of the S loop
constexpr int RED_WARPS = 8;        // ba_reduce: warps (block groups) per block
constexpr int MAX_POSES = 16;
constexpr int BS_THREADS = 128;     // ba_backsub: one thread per landmark

__host__ __device__ inline int pad_j(int P) { return (7 * P) | 1; }
__host__ __device__ inline int pad_g(int P) { return 6 * P + 1; }
__host__ __device__ inline int part_floats(int P) {
    return P * 42 + 6 * P * (6 * P + 1);
}
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared memory of ba_assemble with LT landmarks per block: region A (Jp | r,
// then G | bl), region B (Hll partials, then Gh) and the poses.
__host__ __device__ inline int smem_a_floats(int P, int LT) {
    return 3 * LT * imax(pad_j(P), pad_g(P));
}
__host__ __device__ inline int smem_b_floats(int P, int LT) {
    return imax(3 * LT * pad_g(P), 9 * THREADS);
}
inline size_t assemble_smem_bytes(int P, int LT) {
    return sizeof(float) * (size_t)(smem_a_floats(P, LT) + smem_b_floats(P, LT)
                                    + MAX_POSES * 12);
}

// The 27 sums a pose owns in the Hpp/bp step: the upper triangle (i <= c) of
// its 6x6 block and, as column 6, its 6 entries of bp.
__constant__ unsigned char PAIR_I[27] = {0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
                                         2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
                                         5, 5};
__constant__ unsigned char PAIR_C[27] = {0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6,
                                         2, 3, 4, 5, 6, 3, 4, 5, 6, 4, 5, 6,
                                         5, 6};

struct Planes {
    float rw[3];        // weighted residual
    float jp[3][6];     // weighted d r / d pose (translation, rotation)
    float jl[3][3];     // weighted d r / d landmark
};

// Weighted residual and Jacobian planes of one (pose, landmark) slot: the
// math of ba._dense_residuals_and_jacobians + _huber_weight.  `pose` points
// at 12 floats [R row-major | t].
__device__ __forceinline__ void planes(
    const float* __restrict__ pose, float X0, float X1, float X2,
    float u_m, float v_m, float z_m, float zval, float w_slot,
    float fx, float fy, float cx, float cy, float huber, Planes& o) {
    const float R00 = pose[0], R01 = pose[1], R02 = pose[2];
    const float R10 = pose[3], R11 = pose[4], R12 = pose[5];
    const float R20 = pose[6], R21 = pose[7], R22 = pose[8];
    const float x = R00 * X0 + R01 * X1 + R02 * X2 + pose[9];
    const float y = R10 * X0 + R11 * X1 + R12 * X2 + pose[10];
    const float z = R20 * X0 + R21 * X1 + R22 * X2 + pose[11];
    const float iz = 1.0f / fmaxf(z, 1e-6f);
    const float u = fx * x * iz + cx;
    const float v = fy * y * iz + cy;
    const float wz = (zval > 0.5f) ? fx / fmaxf(z_m, 0.1f) : 0.0f;
    const float r0 = u - u_m, r1 = v - v_m, r2 = wz * (z - z_m);
    const float w_valid = (z > 1e-3f) ? w_slot : 0.0f;
    const float n = sqrtf(r0 * r0 + r1 * r1 + r2 * r2);
    const float wh = sqrtf(fminf(1.0f, huber / fmaxf(n, 1e-12f))) * w_valid;

    o.rw[0] = r0 * wh;
    o.rw[1] = r1 * wh;
    o.rw[2] = r2 * wh;
    // J_proj rows (a, b, c); the zeros of rows 0..2 are written out so no
    // product with a literal zero is computed:
    //   row 0: (fx iz, 0, -fx x iz^2)   row 1: (0, fy iz, -fy y iz^2)
    //   row 2: (0, 0, wz)
    // Jp[r] = [a, b, c, c y - b z, a z - c x, b x - a y]
    // Jl[r][j] = a R0j + b R1j + c R2j
    const float a0 = fx * iz * wh;
    const float c0 = -fx * x * iz * iz * wh;
    const float b1 = fy * iz * wh;
    const float c1 = -fy * y * iz * iz * wh;
    const float c2 = wz * wh;
    o.jp[0][0] = a0;   o.jp[0][1] = 0.0f; o.jp[0][2] = c0;
    o.jp[0][3] = c0 * y;          o.jp[0][4] = a0 * z - c0 * x;
    o.jp[0][5] = -(a0 * y);
    o.jp[1][0] = 0.0f; o.jp[1][1] = b1;   o.jp[1][2] = c1;
    o.jp[1][3] = c1 * y - b1 * z; o.jp[1][4] = -(c1 * x);
    o.jp[1][5] = b1 * x;
    o.jp[2][0] = 0.0f; o.jp[2][1] = 0.0f; o.jp[2][2] = c2;
    o.jp[2][3] = c2 * y;          o.jp[2][4] = -(c2 * x);
    o.jp[2][5] = 0.0f;
    o.jl[0][0] = a0 * R00 + c0 * R20;
    o.jl[0][1] = a0 * R01 + c0 * R21;
    o.jl[0][2] = a0 * R02 + c0 * R22;
    o.jl[1][0] = b1 * R10 + c1 * R20;
    o.jl[1][1] = b1 * R11 + c1 * R21;
    o.jl[1][2] = b1 * R12 + c1 * R22;
    o.jl[2][0] = c2 * R20;
    o.jl[2][1] = c2 * R21;
    o.jl[2][2] = c2 * R22;
}

// The planes of slot (p, l), with the slot's observation read from device
// memory (zeros for a tail thread: zero weight, so every plane is zero).
__device__ __forceinline__ void slot_planes(
    const float* __restrict__ obs, const float* __restrict__ s_pose,
    int P, int L, int p, int l, bool in_range,
    float X0, float X1, float X2,
    float fx, float fy, float cx, float cy, float huber, Planes& o) {
    float u_m = 0.0f, v_m = 0.0f, z_m = 0.0f, zval = 0.0f, w_slot = 0.0f;
    if (in_range) {
        const size_t plane = (size_t)P * L;
        const size_t at = (size_t)p * L + l;
        u_m = obs[at];
        v_m = obs[plane + at];
        z_m = obs[2 * plane + at];
        zval = obs[3 * plane + at];
        w_slot = obs[4 * plane + at];
    }
    planes(s_pose + 12 * p, X0, X1, X2, u_m, v_m, z_m, zval, w_slot,
           fx, fy, cx, cy, huber, o);
}

template <int LT>
__global__ void __launch_bounds__(THREADS)
ba_assemble_kernel(const float* __restrict__ poses,
                   const float* __restrict__ points,
                   const float* __restrict__ obs,
                   const float* __restrict__ lm_free,
                   const float* __restrict__ scal,
                   int P, int L,
                   float* __restrict__ work,
                   float* __restrict__ hinv_out,
                   float* __restrict__ bl_out) {
    constexpr int PG = THREADS / LT;                    // pose groups
    extern __shared__ float smem[];
    const int padJ = pad_j(P), padG = pad_g(P);
    float* sA = smem;                                   // Jp|r, then G|bl
    float* sB = sA + smem_a_floats(P, LT);              // Hll partials, then Gh
    float* s_pose = sB + smem_b_floats(P, LT);

    const int tid = threadIdx.x;
    const int ll = tid % LT;            // landmark within the block
    const int g = tid / LT;             // pose group
    const int l = blockIdx.x * LT + ll;
    const bool in_range = l < L;

    for (int i = tid; i < P * 12; i += THREADS) s_pose[i] = poses[i];
    const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
    const float lam = scal[4], huber = scal[5];
    float X0 = 0.0f, X1 = 0.0f, X2 = 0.0f, freel = 0.0f;
    if (in_range) {
        X0 = points[l];
        X1 = points[(size_t)L + l];
        X2 = points[2 * (size_t)L + l];
        freel = lm_free[l];
    }
    __syncthreads();

    // ---- pass 1: Hll, bl in registers; weighted Jp and r staged ---------
    float h00 = 0.0f, h01 = 0.0f, h02 = 0.0f, h11 = 0.0f, h12 = 0.0f,
          h22 = 0.0f, bl0 = 0.0f, bl1 = 0.0f, bl2 = 0.0f;
    Planes q;
    for (int p = g; p < P; p += PG) {
        slot_planes(obs, s_pose, P, L, p, l, in_range, X0, X1, X2,
                    fx, fy, cx, cy, huber, q);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            h00 += q.jl[r][0] * q.jl[r][0];
            h01 += q.jl[r][0] * q.jl[r][1];
            h02 += q.jl[r][0] * q.jl[r][2];
            h11 += q.jl[r][1] * q.jl[r][1];
            h12 += q.jl[r][1] * q.jl[r][2];
            h22 += q.jl[r][2] * q.jl[r][2];
            bl0 -= q.jl[r][0] * q.rw[r];
            bl1 -= q.jl[r][1] * q.rw[r];
            bl2 -= q.jl[r][2] * q.rw[r];
            float* col = sA + (size_t)(r * LT + ll) * padJ + p * 7;
#pragma unroll
            for (int i = 0; i < 6; ++i) col[i] = q.jp[r][i];
            col[6] = q.rw[r];
        }
    }
    {
        float* red = sB + (size_t)(g * 9) * LT + ll;
        red[0 * LT] = h00; red[1 * LT] = h01; red[2 * LT] = h02;
        red[3 * LT] = h11; red[4 * LT] = h12; red[5 * LT] = h22;
        red[6 * LT] = bl0; red[7 * LT] = bl1; red[8 * LT] = bl2;
    }
    __syncthreads();
    {
        float acc[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) acc[c] = sB[(size_t)c * LT + ll];
        for (int gg = 1; gg < PG; ++gg) {
#pragma unroll
            for (int c = 0; c < 9; ++c)
                acc[c] += sB[(size_t)(gg * 9 + c) * LT + ll];
        }
        h00 = acc[0]; h01 = acc[1]; h02 = acc[2];
        h11 = acc[3]; h12 = acc[4]; h22 = acc[5];
        bl0 = acc[6]; bl1 = acc[7]; bl2 = acc[8];
    }

    // LM damping, identity for frozen landmarks, symmetric adjugate inverse
    float i00, i01, i02, i11, i12, i22;
    {
        const bool fr = freel > 0.0f;
        const float a = fr ? h00 + lam * fmaxf(h00, 1e-6f) : 1.0f;
        const float e = fr ? h11 + lam * fmaxf(h11, 1e-6f) : 1.0f;
        const float k = fr ? h22 + lam * fmaxf(h22, 1e-6f) : 1.0f;
        const float b = fr ? h01 : 0.0f;
        const float c = fr ? h02 : 0.0f;
        const float f = fr ? h12 : 0.0f;
        const float c11 = e * k - f * f;
        const float c12 = c * f - b * k;
        const float c13 = b * f - c * e;
        const float c22 = a * k - c * c;
        const float c23 = c * b - a * f;
        const float c33 = a * e - b * b;
        const float det = a * c11 + b * c12 + c * c13;
        const float inv_det = 1.0f / det;
        i00 = c11 * inv_det; i01 = c12 * inv_det; i02 = c13 * inv_det;
        i11 = c22 * inv_det; i12 = c23 * inv_det; i22 = c33 * inv_det;
    }
    if (g == 0 && in_range) {
        const size_t Ls = (size_t)L;
        hinv_out[0 * Ls + l] = i00; hinv_out[1 * Ls + l] = i01;
        hinv_out[2 * Ls + l] = i02; hinv_out[3 * Ls + l] = i01;
        hinv_out[4 * Ls + l] = i11; hinv_out[5 * Ls + l] = i12;
        hinv_out[6 * Ls + l] = i02; hinv_out[7 * Ls + l] = i12;
        hinv_out[8 * Ls + l] = i22;
        bl_out[0 * Ls + l] = bl0;
        bl_out[1 * Ls + l] = bl1;
        bl_out[2 * Ls + l] = bl2;
    }

    float* part = work + (size_t)blockIdx.x * part_floats(P);

    // ---- Hpp diagonal blocks and bp from the staged Jp | r -------------
    // partial layout o = (p, i, c): c < 6 is Hpp[p][i][c], c == 6 is bp[p][i];
    // a block is symmetric, so each thread sums one entry of its upper
    // triangle and stores it twice
    for (int o = tid; o < P * 27; o += THREADS) {
        const int p = o / 27, rem = o - p * 27;
        const int i = PAIR_I[rem], c = PAIR_C[rem];
        const float* a = sA + p * 7 + i;
        const float* b = sA + p * 7 + c;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < 3 * LT; ++k)
            acc += a[(size_t)k * padJ] * b[(size_t)k * padJ];
        if (c == 6) {
            part[p * 42 + i * 7 + 6] = -acc;
        } else {
            part[p * 42 + i * 7 + c] = acc;
            part[p * 42 + c * 7 + i] = acc;
        }
    }
    __syncthreads();        // sA (Jp) and sB (Hll partials) are reused below

    // ---- pass 2: planes again, G and Gh = G Hll^-1 staged --------------
    for (int p = g; p < P; p += PG) {
        slot_planes(obs, s_pose, P, L, p, l, in_range, X0, X1, X2,
                    fx, fy, cx, cy, huber, q);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            // G[i][j] = sum_r Jp[r][i] Jl[r][j]
            const float g0 = q.jp[0][i] * q.jl[0][0] + q.jp[1][i] * q.jl[1][0]
                           + q.jp[2][i] * q.jl[2][0];
            const float g1 = q.jp[0][i] * q.jl[0][1] + q.jp[1][i] * q.jl[1][1]
                           + q.jp[2][i] * q.jl[2][1];
            const float g2 = q.jp[0][i] * q.jl[0][2] + q.jp[1][i] * q.jl[1][2]
                           + q.jp[2][i] * q.jl[2][2];
            // Gh[i][m] = sum_k G[i][k] Hinv[k][m]
            const float gh0 = g0 * i00 + g1 * i01 + g2 * i02;
            const float gh1 = g0 * i01 + g1 * i11 + g2 * i12;
            const float gh2 = g0 * i02 + g1 * i12 + g2 * i22;
            const int row = p * 6 + i;
            sA[(size_t)(0 * LT + ll) * padG + row] = g0;
            sA[(size_t)(1 * LT + ll) * padG + row] = g1;
            sA[(size_t)(2 * LT + ll) * padG + row] = g2;
            sB[(size_t)(0 * LT + ll) * padG + row] = gh0;
            sB[(size_t)(1 * LT + ll) * padG + row] = gh1;
            sB[(size_t)(2 * LT + ll) * padG + row] = gh2;
        }
    }
    if (g == 0) {                       // bl as row 6P of G
        sA[(size_t)(0 * LT + ll) * padG + 6 * P] = bl0;
        sA[(size_t)(1 * LT + ll) * padG + 6 * P] = bl1;
        sA[(size_t)(2 * LT + ll) * padG + 6 * P] = bl2;
    }
    __syncthreads();

    // ---- S = Gh G^T (6P x 6P) and rhs = Gh bl (column 6P) --------------
    // 4x4 register tiles; a tile's rows are ti + q*MT and its columns
    // tj + q*NT, so the threads of a warp read neighbouring words.
    const int M = 6 * P, N = 6 * P + 1;
    const int MT = (M + 3) / 4, NT = (N + 3) / 4;
    float* s_part = part + P * 42;
    for (int t = tid; t < MT * NT; t += THREADS) {
        const int ti = t / NT, tj = t - ti * NT;
        int ra[4], cb[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            ra[s] = min(ti + s * MT, M - 1);
            cb[s] = min(tj + s * NT, N - 1);
        }
        float acc[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[s][u] = 0.0f;
#pragma unroll (S_UNROLL)
        for (int k = 0; k < 3 * LT; ++k) {
            const float* gh = sB + (size_t)k * padG;
            const float* gg = sA + (size_t)k * padG;
            float a[4], b[4];
#pragma unroll
            for (int s = 0; s < 4; ++s) { a[s] = gh[ra[s]]; b[s] = gg[cb[s]]; }
#pragma unroll
            for (int s = 0; s < 4; ++s)
#pragma unroll
                for (int u = 0; u < 4; ++u) acc[s][u] += a[s] * b[u];
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const int row = ti + s * MT;
            if (row >= M) continue;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int col = tj + u * NT;
                if (col < N) s_part[(size_t)row * N + col] = acc[s][u];
            }
        }
    }
}

// Adds the blocks' partial sums in a fixed order and writes Hpp, bp, S and rhs
// in their final layouts.  A block owns 32 consecutive outputs; warp w adds
// the partials of the blocks b = w, w + 8, ... in that order (its 32 lanes
// read 32 consecutive floats), then the eight warps' sums are added in the
// order w = 0..7.  The order depends on the shapes only, never on timing.
__global__ void __launch_bounds__(32 * RED_WARPS)
ba_reduce_kernel(const float* __restrict__ work, int P, int nblocks,
                 float* __restrict__ Hpp, float* __restrict__ S,
                 float* __restrict__ bp, float* __restrict__ rhs) {
    __shared__ float s_sum[RED_WARPS][32];
    const int n = part_floats(P);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int e = blockIdx.x * 32 + lane;
    float acc = 0.0f;
    if (e < n) {
#pragma unroll 4
        for (int b = w; b < nblocks; b += RED_WARPS)
            acc += work[(size_t)b * n + e];
    }
    s_sum[w][lane] = acc;
    __syncthreads();
    if (w != 0 || e >= n) return;
    acc = s_sum[0][lane];
#pragma unroll
    for (int k = 1; k < RED_WARPS; ++k) acc += s_sum[k][lane];
    if (e < P * 42) {
        const int pi = e / 7, c = e - pi * 7;       // pi = p*6 + i
        if (c < 6) Hpp[pi * 6 + c] = acc;
        else bp[pi] = acc;
    } else {
        const int M = 6 * P, N = 6 * P + 1;
        const int s = e - P * 42;
        const int row = s / N, col = s - row * N;
        if (col < M) S[row * M + col] = acc;
        else rhs[row] = acc;
    }
}

__global__ void __launch_bounds__(BS_THREADS)
ba_backsub_kernel(const float* __restrict__ poses,
                  const float* __restrict__ points,
                  const float* __restrict__ obs,
                  const float* __restrict__ lm_free,
                  const float* __restrict__ scal,
                  const float* __restrict__ hinv,
                  const float* __restrict__ bl,
                  const float* __restrict__ dxp,
                  int P, int L, float* __restrict__ dxl) {
    __shared__ float s_pose[MAX_POSES * 12];
    __shared__ float s_dxp[MAX_POSES * 6];
    const int tid = threadIdx.x;
    for (int i = tid; i < P * 12; i += BS_THREADS) s_pose[i] = poses[i];
    for (int i = tid; i < P * 6; i += BS_THREADS) s_dxp[i] = dxp[i];
    __syncthreads();
    const int l = blockIdx.x * BS_THREADS + tid;
    if (l >= L) return;
    const size_t Ls = (size_t)L;
    const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
    const float huber = scal[5];
    const float X0 = points[l], X1 = points[Ls + l], X2 = points[2 * Ls + l];
    // resid[j] = bl[j] - sum_{p,r} Jl[r][j] (sum_i Jp[r][i] dxp[p][i])
    float e0 = bl[l], e1 = bl[Ls + l], e2 = bl[2 * Ls + l];
    Planes q;
    for (int p = 0; p < P; ++p) {
        slot_planes(obs, s_pose, P, L, p, l, true, X0, X1, X2,
                    fx, fy, cx, cy, huber, q);
        const float* d = s_dxp + 6 * p;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            float u = 0.0f;
#pragma unroll
            for (int i = 0; i < 6; ++i) u += q.jp[r][i] * d[i];
            e0 -= q.jl[r][0] * u;
            e1 -= q.jl[r][1] * u;
            e2 -= q.jl[r][2] * u;
        }
    }
    const float fr = lm_free[l];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const float v = hinv[(3 * j + 0) * Ls + l] * e0
                      + hinv[(3 * j + 1) * Ls + l] * e1
                      + hinv[(3 * j + 2) * Ls + l] * e2;
        dxl[j * Ls + l] = v * fr;
    }
}

}  // namespace

// Plain C entries: enqueue on `stream`, no synchronisation, no allocation.
// Each returns a cudaError_t as an int (0 = launched); 1 (invalid value)
// for a pose count outside 1..ba_max_poses().

extern "C" int ba_max_poses() { return MAX_POSES; }

// Landmarks per block of ba_assemble: 64 when that still gives every SM a
// block, else 32 (timed on an H100: 32 is faster at L = 4,096, 64 at 16,384).
static int landmarks_per_block(int L) {
    static int sm_count = 0;
    if (sm_count == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess || sm_count <= 0)
            sm_count = 132;
    }
    return (L + 63) / 64 >= sm_count ? 64 : 32;
}

// Floats of workspace ba_assemble_launch needs for (P, L).
extern "C" long long ba_workspace_floats(int P, int L) {
    const int lt = landmarks_per_block(L);
    const long long nblocks = (L + lt - 1) / lt;
    return nblocks * part_floats(P);
}

template <int LT>
static cudaError_t launch_assemble(
    const float* poses, const float* points, const float* obs,
    const float* lm_free, const float* scal, int P, int L, float* work,
    float* hinv, float* bl, cudaStream_t st) {
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            ba_assemble_kernel<LT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)assemble_smem_bytes(MAX_POSES, LT));
        if (err != cudaSuccess) return err;
        attr_set = true;
    }
    ba_assemble_kernel<LT><<<(L + LT - 1) / LT, THREADS,
                             assemble_smem_bytes(P, LT), st>>>(
        poses, points, obs, lm_free, scal, P, L, work, hinv, bl);
    return cudaGetLastError();
}

extern "C" int ba_assemble_launch(
    const float* poses, const float* points, const float* obs,
    const float* lm_free, const float* scal, int P, int L, float* work,
    float* Hpp, float* S, float* bp, float* rhs, float* hinv, float* bl,
    void* stream) {
    if (P < 1 || P > MAX_POSES || L < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int lt = landmarks_per_block(L);
    const cudaError_t err =
        lt == 64 ? launch_assemble<64>(poses, points, obs, lm_free, scal, P, L,
                                       work, hinv, bl, st)
                 : launch_assemble<32>(poses, points, obs, lm_free, scal, P, L,
                                       work, hinv, bl, st);
    if (err != cudaSuccess) return (int)err;
    const int n = part_floats(P);
    ba_reduce_kernel<<<(n + 31) / 32, 32 * RED_WARPS, 0, st>>>(
        work, P, (L + lt - 1) / lt, Hpp, S, bp, rhs);
    return (int)cudaGetLastError();
}

extern "C" int ba_backsub_launch(
    const float* poses, const float* points, const float* obs,
    const float* lm_free, const float* scal, const float* hinv,
    const float* bl, const float* dxp, int P, int L, float* dxl,
    void* stream) {
    if (P < 1 || P > MAX_POSES || L < 1) return (int)cudaErrorInvalidValue;
    const int nblocks = (L + BS_THREADS - 1) / BS_THREADS;
    ba_backsub_kernel<<<nblocks, BS_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        poses, points, obs, lm_free, scal, hinv, bl, dxp, P, L, dxl);
    return (int)cudaGetLastError();
}
