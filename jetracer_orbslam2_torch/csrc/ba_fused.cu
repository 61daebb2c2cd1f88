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
// Schur product costs about (6n)(6n+1)*3 f32 operations for the n poses that
// observe it, one triangle of the symmetric product (5.4 k at n = 6) against
// 4*(5P+4) bytes (176 B at P = 8): 117.3 M operations = 1.75 us at (P 8,
// L 16,384) against 67 TFLOP/s.  ba_backsub is bound by bytes (3.87 MB at
// (8, 16,384): 1.15 us), yet one thread a landmark walking all P poses made
// it a chain of ~150 dependent operations and 5 loads a pose on 1-4 warps
// an SM; its design (thread (pose, landmark), a 9-FMA fold) is at the
// kernel.
//
// Design of ba_assemble (persistent split-K; not the TPU kernel's, which puts
// 8 poses on the sublanes, a 1,024-landmark tile on the lanes and carries its
// sums from grid step to grid step in order).  A grid of at most two blocks
// an SM (an occupancy query; at most one at P > 8) walks the landmark tiles
// of LT = 32: block b takes tiles b, b + grid, ...  Per tile, 256 threads:
//   prefetch the NEXT tile's obs (5,P,LT), points (3,LT) and free (LT) go to
//            the other half of a shared double buffer with cp.async (16-byte
//            copies when L % 4 == 0, 4-byte copies otherwise; zero fill past
//            L, so a tail landmark computes on zeros and stores nothing)
//            while this tile's S product runs.  Both passes read the
//            observations from shared memory.
//   pass 1   thread (g, l), g = 0..7 a pose group: the weighted residual and
//            Jacobian planes of the poses p = g, g + 8, ... for landmark l;
//            Hll (6) and bl (3) in registers; Jp | r staged.  The groups'
//            Hll/bl partials meet in shared memory and are added in the order
//            g = 0..7, then damping, the identity for frozen landmarks and
//            the symmetric adjugate inverse follow in registers; Hll^-1 and
//            bl go to device memory.
//   pass 2   G needs Hll^-1, which needs every pose, so the pose loop runs a
//            second time.  The planes of a thread's last pose of pass 1 are
//            still in registers (at P <= 8 its only pose: nothing is
//            recomputed); any other pose's are RECOMPUTED (about 150
//            operations per slot) rather than staged.  G | bl and
//            Gh = G Hll^-1 are staged.
//   product  the block's 256 threads are KG column groups x T tiles, T = P
//            (Jp Jp^T | Jp r: Hpp and bp of one pose) + P(P+1)/2 (Gh_a G_b^T
//            | Gh_a bl for pose pairs a <= b: the upper triangle of S and the
//            rhs).  Every tile is a 6x6 + 6 register tile, the same loop for
//            both kinds; group g takes the staged columns k = g, g + KG, ...
//            of the 3*LT (a column: three float2 of each operand, one float).
//            The 42 sums stay in registers ACROSS the block's tiles: a
//            split-K over landmarks.  FP32 FMA, no tensor cores (TF32 would
//            break f32 parity with the dense route).
// After its last tile the block adds its KG groups in order and writes ONE
// partial of T*42 floats (1,848 at P = 8).  ba_reduce_kernel then adds the
// partials in block order; the order depends on the shapes only, never on
// timing, and no atomic is used: two launches on the same inputs agree bit
// for bit.  Mirroring fills the lower triangle of S and of each Hpp block.
// (A one-launch variant, in which the last-arriving blocks of groups of 16
// added the partials behind integer counters, was measured slower by 6-7 us
// at both shapes of the path: one block adding 16 partials has too few loads
// in flight; PERF.md, PR 4.)
//
// Shared memory: MAX_POSES*12 + 2*(5P+4)*LT + 3LT*(8P+2) + 2*3LT*(6P+2)
// + 9*256 floats: 83.0 KB at P = 8 (two blocks an SM) and 153.0 KB at P = 16
// (one), which is why MAX_POSES is 16 (the card allows a block 227 KB).
// Registers: launch bounds of two 256-thread blocks an SM (<= 128 a thread).
// Any L >= 1, any 1 <= P <= 16.
//
// Arithmetic: IEEE division and square root (do not build with
// --use_fast_math); the compiler contracts a*b+c into FMAs, so sums differ
// from eager PyTorch in the last bits, and the order of the sums over
// landmarks differs too.  The comparison with the plain version therefore
// has a tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // ba_assemble: LT landmarks x PG pose groups
constexpr int LT = 32;              // landmarks a tile
constexpr int PG = THREADS / LT;    // pose groups
constexpr int KCOLS = 3 * LT;       // staged columns a tile
constexpr int MAX_KG = 8;           // column groups of the product
constexpr int ACC = 42;             // sums of a product tile: 6x6 + 6
constexpr int RED_WARPS = 16;       // ba_reduce: warps (block groups) per block
constexpr int MAX_POSES = 16;
constexpr int BS_LM = 32;           // ba_backsub: landmarks a block (lanes)
constexpr int BS_WARPS = 8;         //   x pose warps
constexpr int BS_THREADS = 32 * BS_WARPS;
constexpr int BS_STAGE = 12;        //   staged floats a slot: Jl (9) | u (3)

// Row pitches of the staged columns: even, so that a pose's six entries are
// read as three float2; at P = 8 and 16 a warp's stores (32 landmarks, one
// pitch apart) meet at most two to a bank.
__host__ __device__ inline int pad_j(int P) { return 8 * P + 2; }   // Jp | r | 0
__host__ __device__ inline int pad_g(int P) { return 6 * P + 2; }   // G | bl | 0
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
// product tiles: P pose blocks (Hpp | bp) + P(P+1)/2 pose pairs (S | rhs)
__host__ __device__ inline int n_tiles(int P) { return P + P * (P + 1) / 2; }
__host__ __device__ inline int col_groups(int P) {
    return imax(1, imin(MAX_KG, THREADS / n_tiles(P)));
}
__host__ __device__ inline int part_floats(int P) { return n_tiles(P) * ACC; }

// Shared memory of ba_assemble, in floats, region by region.
__host__ __device__ inline int smem_obs_floats(int P) { return 2 * 5 * P * LT; }
__host__ __device__ inline int smem_aux_floats() { return 2 * 4 * LT; }
__host__ __device__ inline int smem_j_floats(int P) { return KCOLS * pad_j(P); }
__host__ __device__ inline int smem_g_floats(int P) { return KCOLS * pad_g(P); }
__host__ __device__ inline int smem_r_floats() { return 9 * THREADS; }
inline size_t assemble_smem_bytes(int P) {
    // the staging regions (J, G, H, R) take the column groups' sums at the end
    const int staging = imax(smem_j_floats(P) + 2 * smem_g_floats(P) + smem_r_floats(),
                             col_groups(P) * part_floats(P));
    return sizeof(float) * (size_t)(MAX_POSES * 12 + smem_obs_floats(P) +
                                    smem_aux_floats() + staging);
}

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


// The planes of slot (p, ll) of a landmark tile staged in shared memory
// (`so` is its obs, (5, P, LT)); the same values, and so the same arithmetic,
// as slot_planes on device memory.
__device__ __forceinline__ void tile_planes(
    const float* __restrict__ so, const float* __restrict__ s_pose,
    int P, int p, int ll, float X0, float X1, float X2,
    float fx, float fy, float cx, float cy, float huber, Planes& o) {
    const int plane = P * LT, at = p * LT + ll;
    planes(s_pose + 12 * p, X0, X1, X2, so[at], so[plane + at],
           so[2 * plane + at], so[3 * plane + at], so[4 * plane + at],
           fx, fy, cx, cy, huber, o);
}

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

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of landmark tile `tile`: rows 0..5P-1 are obs (c*P + p),
// then points x, y, z and free, LT landmarks each, zero past L.  A copy that
// reads nothing (src-size 0) is given a valid address all the same.
__device__ __forceinline__ void load_landmarks(
    const float* __restrict__ obs, const float* __restrict__ points,
    const float* __restrict__ lm_free, int P, int L, bool vec4, int tile,
    float* so, float* sa) {
    const int l0 = tile * LT, rows = 5 * P + 4;
    auto row_src = [&](int r) -> const float* {
        if (r < 5 * P) return obs + (size_t)r * L;
        if (r < 5 * P + 3) return points + (size_t)(r - 5 * P) * L;
        return lm_free;
    };
    auto row_dst = [&](int r) -> float* {
        return r < 5 * P ? so + r * LT : sa + (r - 5 * P) * LT;
    };
    if (vec4) {             // L % 4 == 0: a 4-landmark chunk is all in or out
        constexpr int CW = LT / 4;
        for (int i = threadIdx.x; i < rows * CW; i += THREADS) {
            const int r = i / CW, c = 4 * (i - r * CW);
            const float* src = row_src(r);
            const bool ok = l0 + c < L;
            cp_async16(row_dst(r) + c, ok ? src + l0 + c : src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < rows * LT; i += THREADS) {
            const int r = i / LT, c = i - r * LT;
            const float* src = row_src(r);
            const bool ok = l0 + c < L;
            cp_async4(row_dst(r) + c, ok ? src + l0 + c : src, ok);
        }
    }
}

// Pose pair q (0-based, a <= b, row-major over the upper triangle) -> (a, b).
__device__ __forceinline__ void pair_of(int q, int P, int& a, int& b) {
    a = 0;
    int n = P;
    while (q >= n) { q -= n; ++a; --n; }
    b = a + q;
}

// Writes sum e of the partial layout (tile t = e / 42, entry c = e % 42) to
// its place(s) in the outputs.  Pose tiles t < P: c < 36 is Jp Jp^T[i][j],
// c >= 36 is Jp r (bp = -Jp r).  Pair tiles (a, b): c < 36 is S[a*6+i][b*6+j],
// c >= 36 is rhs[a*6+i] (kept for a == b only).  The upper triangle of each
// symmetric block is written twice, the lower one computed never.
__device__ __forceinline__ void emit(int P, int e, float v, float* __restrict__ Hpp,
                                     float* __restrict__ S, float* __restrict__ bp,
                                     float* __restrict__ rhs) {
    const int t = e / ACC, c = e - t * ACC;
    if (t < P) {
        if (c >= 36) { bp[t * 6 + c - 36] = -v; return; }
        const int i = c / 6, j = c - i * 6;
        if (i > j) return;
        Hpp[t * 36 + i * 6 + j] = v;
        Hpp[t * 36 + j * 6 + i] = v;
        return;
    }
    int a, b;
    pair_of(t - P, P, a, b);
    if (c >= 36) {
        if (a == b) rhs[a * 6 + c - 36] = v;
        return;
    }
    const int i = c / 6, j = c - i * 6;
    if (a == b && i > j) return;
    const int M = 6 * P;
    S[(a * 6 + i) * M + b * 6 + j] = v;
    S[(b * 6 + j) * M + a * 6 + i] = v;
}

__global__ void __launch_bounds__(THREADS, 2)
ba_assemble_kernel(const float* __restrict__ poses,
                   const float* __restrict__ points,
                   const float* __restrict__ obs,
                   const float* __restrict__ lm_free,
                   const float* __restrict__ scal,
                   int P, int L, int vec4,
                   float* __restrict__ work,
                   float* __restrict__ hinv_out,
                   float* __restrict__ bl_out) {
    extern __shared__ __align__(16) float smem[];
    const int padJ = pad_j(P), padG = pad_g(P);
    float* s_pose = smem;                               // MAX_POSES * 12
    float* s_obs = s_pose + MAX_POSES * 12;             // [2][5][P][LT]
    float* s_aux = s_obs + smem_obs_floats(P);          // [2][4][LT]
    float* sJ = s_aux + smem_aux_floats();              // [3LT][padJ]: p*8: Jp | r
    float* sG = sJ + smem_j_floats(P);                  // [3LT][padG]: p*6: G; bl
    float* sH = sG + smem_g_floats(P);                  // [3LT][padG]: p*6: Gh
    float* sR = sH + smem_g_floats(P);                  // [PG][9][LT]: Hll, bl
    float* s_stage = sJ;                                // [KG][T][42] at the end

    const int tid = threadIdx.x;
    const int ll = tid % LT;            // landmark within the tile
    const int g = tid / LT;             // pose group
    const int ntiles = (L + LT - 1) / LT;
    const int T = n_tiles(P), KG = col_groups(P), n_part = T * ACC;

    for (int i = tid; i < P * 12; i += THREADS) s_pose[i] = poses[i];
    const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
    const float lam = scal[4], huber = scal[5];

    // this thread's product tile: A (6 rows) x B (6 columns) and A x X
    const int kg = tid / T, tile = tid - kg * T;
    const bool active = kg < KG;
    const float *A, *B, *X;
    int stride;
    if (tile < P) {                     // pose block: Jp Jp^T | Jp r
        A = sJ + tile * 8; B = A; X = A + 6; stride = padJ;
    } else {                            // pose pair a <= b: Gh_a G_b^T | Gh_a bl
        int a, b;
        pair_of(tile - P, P, a, b);
        A = sH + a * 6; B = sG + b * 6; X = sG + 6 * P; stride = padG;
    }
    float acc[36], accx[6];
#pragma unroll
    for (int i = 0; i < 36; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) accx[i] = 0.0f;

    // prologue: this block's first two tiles in flight
    const int first = blockIdx.x;
    if (first < ntiles)
        load_landmarks(obs, points, lm_free, P, L, vec4, first, s_obs, s_aux);
    cp_async_commit();
    if (first + (int)gridDim.x < ntiles)
        load_landmarks(obs, points, lm_free, P, L, vec4, first + gridDim.x,
                       s_obs + 5 * P * LT, s_aux + 4 * LT);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();

    int buf = 0;
    for (int cur = first; cur < ntiles; cur += gridDim.x) {
        float* so = s_obs + buf * 5 * P * LT;
        float* sa = s_aux + buf * 4 * LT;
        const int l = cur * LT + ll;
        const bool in_range = l < L;
        const float X0 = sa[ll], X1 = sa[LT + ll], X2 = sa[2 * LT + ll];
        const float freel = sa[3 * LT + ll];

        // ---- pass 1: Hll, bl in registers; weighted Jp and r staged ------
        float h00 = 0.0f, h01 = 0.0f, h02 = 0.0f, h11 = 0.0f, h12 = 0.0f,
              h22 = 0.0f, bl0 = 0.0f, bl1 = 0.0f, bl2 = 0.0f;
        Planes q;
        int last = -1;                  // the pose whose planes q still holds
        for (int p = g; p < P; p += PG) {
            tile_planes(so, s_pose, P, p, ll, X0, X1, X2, fx, fy, cx, cy,
                        huber, q);
            last = p;
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
                float* col = sJ + (size_t)(r * LT + ll) * padJ + p * 8;
#pragma unroll
                for (int i = 0; i < 6; ++i) col[i] = q.jp[r][i];
                col[6] = q.rw[r];
            }
        }
        {
            float* red = sR + (size_t)(g * 9) * LT + ll;
            red[0 * LT] = h00; red[1 * LT] = h01; red[2 * LT] = h02;
            red[3 * LT] = h11; red[4 * LT] = h12; red[5 * LT] = h22;
            red[6 * LT] = bl0; red[7 * LT] = bl1; red[8 * LT] = bl2;
        }
        __syncthreads();
        {
            float sum[9];
#pragma unroll
            for (int c = 0; c < 9; ++c) sum[c] = sR[(size_t)c * LT + ll];
            for (int gg = 1; gg < PG; ++gg) {
#pragma unroll
                for (int c = 0; c < 9; ++c)
                    sum[c] += sR[(size_t)(gg * 9 + c) * LT + ll];
            }
            h00 = sum[0]; h01 = sum[1]; h02 = sum[2];
            h11 = sum[3]; h12 = sum[4]; h22 = sum[5];
            bl0 = sum[6]; bl1 = sum[7]; bl2 = sum[8];
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

        // ---- pass 2: G | bl and Gh = G Hll^-1 staged.  The last pose of pass 1
        // is still in q (at P <= 8 the only one); the others are recomputed.
        for (int p = last; p >= g; p -= PG) {
            if (p != last)
                tile_planes(so, s_pose, P, p, ll, X0, X1, X2, fx, fy, cx, cy,
                            huber, q);
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
                sG[(size_t)(0 * LT + ll) * padG + row] = g0;
                sG[(size_t)(1 * LT + ll) * padG + row] = g1;
                sG[(size_t)(2 * LT + ll) * padG + row] = g2;
                sH[(size_t)(0 * LT + ll) * padG + row] = gh0;
                sH[(size_t)(1 * LT + ll) * padG + row] = gh1;
                sH[(size_t)(2 * LT + ll) * padG + row] = gh2;
            }
        }
        if (g == 0) {                       // bl as row 6P of G
            sG[(size_t)(0 * LT + ll) * padG + 6 * P] = bl0;
            sG[(size_t)(1 * LT + ll) * padG + 6 * P] = bl1;
            sG[(size_t)(2 * LT + ll) * padG + 6 * P] = bl2;
        }
        __syncthreads();

        // every thread is done with this tile's obs: the tile after next goes
        // into this half of the buffer while the product runs
        const int after_next = cur + 2 * (int)gridDim.x;
        if (after_next < ntiles)
            load_landmarks(obs, points, lm_free, P, L, vec4, after_next, so, sa);
        cp_async_commit();

        // ---- product: this thread's 6x6 + 6 sums over its columns ----------
        if (active) {
#pragma unroll 2
            for (int k = kg; k < KCOLS; k += KG) {
                const float2* a = reinterpret_cast<const float2*>(A + (size_t)k * stride);
                const float2* b = reinterpret_cast<const float2*>(B + (size_t)k * stride);
                const float x = X[(size_t)k * stride];
                float av[6], bv[6];
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    const float2 ai = a[i], bi = b[i];
                    av[2 * i] = ai.x; av[2 * i + 1] = ai.y;
                    bv[2 * i] = bi.x; bv[2 * i + 1] = bi.y;
                }
#pragma unroll
                for (int i = 0; i < 6; ++i) {
#pragma unroll
                    for (int j = 0; j < 6; ++j) acc[i * 6 + j] += av[i] * bv[j];
                    accx[i] += av[i] * x;
                }
            }
        }
        // the next tile's copies (issued one tile ago) have landed; after the
        // barrier every thread sees them and none reads this tile's staging
        cp_async_wait_all_but_newest();
        __syncthreads();
        buf ^= 1;
    }

    // ---- this block's partial: its column groups added in order g = 0..KG-1
    if (active) {
        float* st = s_stage + (size_t)(kg * T + tile) * ACC;
#pragma unroll
        for (int i = 0; i < 36; ++i) st[i] = acc[i];
#pragma unroll
        for (int i = 0; i < 6; ++i) st[36 + i] = accx[i];
    }
    __syncthreads();
    float* part = work + (size_t)blockIdx.x * n_part;
    for (int e = tid; e < n_part; e += THREADS) {
        float v = s_stage[e];
        for (int k = 1; k < KG; ++k) v += s_stage[(size_t)k * n_part + e];
        part[e] = v;
    }
}

// Adds the blocks' partials in a fixed order and writes Hpp, bp, S and rhs in
// their final layouts.  A block owns 32 consecutive sums; warp w adds the
// partials of the blocks b = w, w + RED_WARPS, ... in that order (its 32 lanes
// read 32 consecutive floats), then the warps' sums are added in the order
// w = 0..RED_WARPS-1.  The order depends on the shapes only, never on timing.
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
    emit(P, e, acc, Hpp, S, bp, rhs);
}

// ba_backsub: thread (pose, landmark).  A block is BS_LM consecutive
// landmarks (the lanes) x BS_WARPS pose warps; warp w takes the poses
// p = w, w + BS_WARPS, so a warp's obs loads are one 128-byte row a channel.
// Each (p, l) computes its planes (slot_planes, as ba_assemble does) and
// u[r] = sum_i Jp[r][i] dxp[p][i], and stages Jl[r][0..2] | u[r] (12 floats)
// in shared memory.  Then warp 0 folds, one thread a landmark, in the order
// of the plain version's sums: e_j = bl_j, then
// e_j -= Jl[r][j] u[r] over p = 0..P-1 and r = 0..2, then Hll^-1 and free.
// The serial part is 9 FMAs a pose.  Every load comes first: the fold
// warp's bl, Hll^-1 and free, every warp's point and its pose's obs (poses
// and dxp are read in place, broadcast through L1; no barrier before the
// pose loop).
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
    __shared__ float s_stage[MAX_POSES * BS_STAGE * BS_LM];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int l = blockIdx.x * BS_LM + lane;
    const bool in_range = l < L;
    const size_t Ls = (size_t)L;
    float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f, fr = 0.0f;
    float h[9] = {};
    if (w == 0 && in_range) {
        e0 = bl[l]; e1 = bl[Ls + l]; e2 = bl[2 * Ls + l];
#pragma unroll
        for (int m = 0; m < 9; ++m) h[m] = hinv[m * Ls + l];
        fr = lm_free[l];
    }
    float X0 = 0.0f, X1 = 0.0f, X2 = 0.0f;
    if (in_range) { X0 = points[l]; X1 = points[Ls + l]; X2 = points[2 * Ls + l]; }
    const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
    const float huber = scal[5];
    Planes q;
    for (int p = w; p < P; p += BS_WARPS) {
        slot_planes(obs, poses, P, L, p, l, in_range, X0, X1, X2,
                    fx, fy, cx, cy, huber, q);
        const float* d = dxp + 6 * p;
        float* st = s_stage + (size_t)p * BS_STAGE * BS_LM + lane;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            float u = 0.0f;
#pragma unroll
            for (int i = 0; i < 6; ++i) u += q.jp[r][i] * d[i];
            st[(3 * r + 0) * BS_LM] = q.jl[r][0];
            st[(3 * r + 1) * BS_LM] = q.jl[r][1];
            st[(3 * r + 2) * BS_LM] = q.jl[r][2];
            st[(9 + r) * BS_LM] = u;
        }
    }
    __syncthreads();
    if (w != 0 || !in_range) return;
    for (int p = 0; p < P; ++p) {
        const float* st = s_stage + (size_t)p * BS_STAGE * BS_LM + lane;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            const float u = st[(9 + r) * BS_LM];
            e0 -= st[(3 * r + 0) * BS_LM] * u;
            e1 -= st[(3 * r + 1) * BS_LM] * u;
            e2 -= st[(3 * r + 2) * BS_LM] * u;
        }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const float v = h[3 * j + 0] * e0 + h[3 * j + 1] * e1 + h[3 * j + 2] * e2;
        dxl[j * Ls + l] = v * fr;
    }
}


}  // namespace

// Plain C entries: enqueue on `stream`, no synchronisation, no allocation.
// Each returns a cudaError_t as an int (0 = launched); 1 (invalid value)
// for a pose count outside 1..ba_max_poses().

extern "C" int ba_max_poses() { return MAX_POSES; }

// Blocks of ba_assemble for (P, L): as many as the occupancy query lets
// reside at once, capped at two an SM, and never more than there are tiles.
// 0 if the device cannot be queried.
static int assemble_grid(int P, int L) {
    static int per_sm[MAX_POSES + 1] = {0};
    static int sm_count = 0;
    if (sm_count == 0 || per_sm[P] == 0) {
        int dev = 0, sms = 0, n = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess ||
            cudaFuncSetAttribute(ba_assemble_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)assemble_smem_bytes(MAX_POSES)) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, ba_assemble_kernel, THREADS, assemble_smem_bytes(P)) != cudaSuccess)
            return 0;
        sm_count = sms;
        per_sm[P] = imax(1, imin(2, n));
    }
    return imin((L + LT - 1) / LT, per_sm[P] * sm_count);
}

// Floats of workspace ba_assemble_launch needs for (P, L): one partial per
// block.  -1 if the device cannot be queried.
extern "C" long long ba_workspace_floats(int P, int L) {
    if (P < 1 || P > MAX_POSES || L < 1) return -1;
    const int grid = assemble_grid(P, L);
    if (grid <= 0) return -1;
    return (long long)grid * part_floats(P);
}

// ba_assemble_kernel, then ba_reduce_kernel over its partials.
extern "C" int ba_assemble_launch(
    const float* poses, const float* points, const float* obs,
    const float* lm_free, const float* scal, int P, int L, float* work,
    float* Hpp, float* S, float* bp, float* rhs, float* hinv, float* bl,
    void* stream) {
    if (P < 1 || P > MAX_POSES || L < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = assemble_grid(P, L);
    if (grid <= 0) return (int)cudaErrorInvalidDevice;
    auto aligned = [](const void* p) {
        return reinterpret_cast<unsigned long long>(p) % 16 == 0;
    };
    const int vec4 = L % 4 == 0 && aligned(obs) && aligned(points) &&
                     aligned(lm_free);
    ba_assemble_kernel<<<grid, THREADS, assemble_smem_bytes(P), st>>>(
        poses, points, obs, lm_free, scal, P, L, vec4, work, hinv, bl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = part_floats(P);
    ba_reduce_kernel<<<(n + 31) / 32, 32 * RED_WARPS, 0, st>>>(
        work, P, grid, Hpp, S, bp, rhs);
    return (int)cudaGetLastError();
}

extern "C" int ba_backsub_launch(
    const float* poses, const float* points, const float* obs,
    const float* lm_free, const float* scal, const float* hinv,
    const float* bl, const float* dxp, int P, int L, float* dxl,
    void* stream) {
    if (P < 1 || P > MAX_POSES || L < 1) return (int)cudaErrorInvalidValue;
    const int nblocks = (L + BS_LM - 1) / BS_LM;
    ba_backsub_kernel<<<nblocks, BS_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        poses, points, obs, lm_free, scal, hinv, bl, dxp, P, L, dxl);
    return (int)cudaGetLastError();
}
