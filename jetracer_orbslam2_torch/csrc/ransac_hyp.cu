// RANSAC's hypotheses, their scores and the winner for sm_90a, K7: B
// problems of K point pairs and H minimal samples each, in ONE launch.
//   src, dst (B, K, 3) f32, keep (B, K) f32 (match validity, > 0 counts),
//   idx (B, H, 3) int64 (the drawn samples), tz (B, K) f32 (the inlier gate a
//   point) -> best (B,) int64, score (B,) int32, w1 (B, K) f32.
// As jetracer_orbslam2_tpu/models/tracking.py:108-150 (ransac_kabsch)
// computes it before its refit:
//   T_h = kabsch_quat(src[idx[h]], dst[idx[h]])      (ops/geometry.py:301)
//   inl[h, i] = |R_h src_i + t_h - dst_i| < tz_i and keep_i > 0
//   best = the first h of the largest count; w1 = inl[best].
//
// Replaces no TPU kernel: the JAX package runs these ops inside its jitted
// frame step, which XLA fuses.  The port's plain version
// (ops/fused_ransac.ransac_select_reference) is about 420 small PyTorch
// kernels a call (the batched quaternion Kabsch's 30 Newton steps, the
// (H, K) scoring, the first-index argmax), half of a graphed odometry frame's
// nodes, and runs again in every loop verification and relocalization.
//
// What bounds it: not bytes (B 1, H 256, K 1,024 reads 43 KB) and hardly
// operations (27 f32 operations a (hypothesis, point) test, 7.4 M at H 256,
// 0.11 us of the card's peak), but latency: a launch, one serial QCP solve,
// the tests, one exchange.  So:
//   - a problem is split over a thread-block cluster of CTAS blocks of 256
//     threads (CTAS from H: one block a 16 hypotheses, up to 16, a
//     non-portable cluster above 8); block r takes hypotheses [r P, r P + P),
//     P = ceil(H / CTAS);
//   - each block copies the problem's points into shared memory once with
//     cp.async (K <= MAX_STAGED; a larger K is read from global memory, where
//     it stays in L2) while one thread a hypothesis solves it: the plain
//     kabsch_quat's f32 algebra step for step (the centred correlation,
//     Horn's 4 x 4 K, the trace powers, 30 Newton steps on the quartic from
//     sqrt(max(p2, 1e-30)) with the |f'| < 1e-20 guard, the 16 cofactors,
//     the longest column, first index on ties, normalised with a 1e-20
//     clamp, R and t), products and sums rounded one by one as the plain
//     version's separate kernels round them.  Newton stops early only at
//     an exact fixed point (lam repeats bit for bit), after which the plain
//     loop cannot move either;
//   - a warp tests 4 hypotheses against its slice of the points (the warps
//     split the block's hypotheses, then the points), |e|^2 against tz^2
//     widened and narrowed by 1e-6: only where a test falls within that
//     band of its gate does the warp take the square root, so each decision
//     is exactly sqrt(|e|^2) < tz; counts are integers (a warp reduction,
//     then shared-memory integer atomics), so their order does not matter;
//   - each block's best (largest count, then lowest index) with its T goes
//     into every block's shared memory of the cluster by st.async, counted
//     by each block's mbarrier (csrc/cluster.cuh), and every block picks
//     the same winner in block order and writes its share of w1 = the
//     winner's inlier mask.  No float atomics and no second launch: a
//     relaunch and a graph replay repeat bit for bit.
// Denormals are kept (no fast math, no flush to zero): a degenerate sample
// (a point drawn twice, collinear points) runs through them as in the plain
// version.  Indices outside [0, K) are clamped into it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4;              // hypotheses a warp tests together
constexpr int ROUND = THREADS;        // hypotheses a block solves at once
constexpr int HYP_PER_CTA = 16;       // the cluster's size: a block a 16
constexpr int MAX_CTAS = 16;          // above 8 a non-portable cluster
constexpr int MAX_STAGED = 6144;      // points staged in shared memory
constexpr int NEWTON = 30;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// dynamic shared memory of a staged block: src and dst (3 K floats each),
// tz and keep (K each), every array 16-byte aligned
__host__ __device__ inline int staged_bytes(int k) {
    return 4 * (2 * round4(3 * k) + 2 * round4(k));
}

// one rounding a step, as separate PyTorch kernels round: no contraction
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// det of the 3 x 3 minor of A without row j and column i, expanded as
// geometry._adjugate_columns expands it
__device__ __forceinline__ float minor_det(const float (&A)[4][4], int j, int i) {
    int r[3], c[3];
    for (int a = 0, n = 0; a < 4; ++a)
        if (a != j) r[n++] = a;
    for (int a = 0, n = 0; a < 4; ++a)
        if (a != i) c[n++] = a;
    const float m00 = A[r[0]][c[0]], m01 = A[r[0]][c[1]], m02 = A[r[0]][c[2]];
    const float m10 = A[r[1]][c[0]], m11 = A[r[1]][c[1]], m12 = A[r[1]][c[2]];
    const float m20 = A[r[2]][c[0]], m21 = A[r[2]][c[1]], m22 = A[r[2]][c[2]];
    const float a = mul(m00, sub(mul(m11, m22), mul(m12, m21)));
    const float b = mul(m01, sub(mul(m10, m22), mul(m12, m20)));
    const float d = mul(m02, sub(mul(m10, m21), mul(m11, m20)));
    return add(sub(a, b), d);
}

__device__ __forceinline__ float norm4(const float (&v)[4]) {
    return sqrtf(fmaf(v[3], v[3], fmaf(v[2], v[2], fmaf(v[1], v[1], mul(v[0], v[0])))));
}

// T (rows of [R | t], 12 floats) of the quaternion Kabsch fit dst ~ R src + t
// on three pairs: geometry.kabsch_quat with no weights.
__device__ void qcp3(const float (&s)[3][3], const float (&d)[3][3], float* T) {
    float mu_s[3], mu_d[3], sc[3][3], dc[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        mu_s[c] = __fdiv_rn(add(add(s[0][c], s[1][c]), s[2][c]), 3.0f);
        mu_d[c] = __fdiv_rn(add(add(d[0][c], d[1][c]), d[2][c]), 3.0f);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            sc[p][c] = sub(s[p][c], mu_s[c]);
            dc[p][c] = sub(d[p][c], mu_d[c]);
        }
    float H[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            H[i][j] = fmaf(sc[2][i], dc[2][j], fmaf(sc[1][i], dc[1][j], mul(sc[0][i], dc[0][j])));
    const float hxx = H[0][0], hxy = H[0][1], hxz = H[0][2];
    const float hyx = H[1][0], hyy = H[1][1], hyz = H[1][2];
    const float hzx = H[2][0], hzy = H[2][1], hzz = H[2][2];
    const float K[4][4] = {
        {add(add(hxx, hyy), hzz), sub(hyz, hzy), sub(hzx, hxz), sub(hxy, hyx)},
        {sub(hyz, hzy), sub(sub(hxx, hyy), hzz), add(hxy, hyx), add(hzx, hxz)},
        {sub(hzx, hxz), add(hxy, hyx), sub(add(-hxx, hyy), hzz), add(hyz, hzy)},
        {sub(hxy, hyx), add(hzx, hxz), add(hyz, hzy), add(sub(-hxx, hyy), hzz)}};
    float K2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float a = mul(K[i][0], K[0][j]);
#pragma unroll
            for (int m = 1; m < 4; ++m) a = fmaf(K[i][m], K[m][j], a);
            K2[i][j] = a;
        }
    const float p2 = add(add(add(K2[0][0], K2[1][1]), K2[2][2]), K2[3][3]);
    float p3 = 0.0f, p4 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            p3 = add(p3, mul(K2[i][j], K[j][i]));
            p4 = add(p4, mul(K2[i][j], K2[j][i]));
        }
    const float e2 = mul(-0.5f, p2);
    const float e3 = __fdiv_rn(p3, 3.0f);
    const float e4 = mul(sub(mul(mul(0.5f, p2), p2), p4), 0.25f);
    // torch.clamp_min keeps a NaN, fmaxf would not
    float lam = sqrtf(p2 < 1e-30f ? 1e-30f : p2);
    const float neg_e3 = -e3, two_e2 = mul(2.0f, e2);
    for (int it = 0; it < NEWTON; ++it) {
        float f = fmaf(lam, lam, e2);
        f = fmaf(f, lam, neg_e3);
        f = fmaf(f, lam, e4);
        float fp = fmaf(mul(4.0f, lam), lam, two_e2);
        fp = fmaf(fp, lam, neg_e3);
        fp = fabsf(fp) < 1e-20f ? 1e-20f : fp;
        const float next = sub(lam, __fdiv_rn(f, fp));
        // a step is a function of lam alone: a repeat stays for good
        if (__float_as_uint(next) == __float_as_uint(lam)) break;
        lam = next;
    }
    float A[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) A[i][j] = sub(K[i][j], mul(lam, i == j ? 1.0f : 0.0f));
    // row j of the cofactors is column j of adj(A); the longest, first on ties
    float best[4], best_norm = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            col[i] = mul(((i + j) & 1) ? -1.0f : 1.0f, minor_det(A, j, i));
        const float n = norm4(col);
        if (j == 0 || n > best_norm) {
            best_norm = n;
#pragma unroll
            for (int i = 0; i < 4; ++i) best[i] = col[i];
        }
    }
    const float qn = best_norm < 1e-20f ? 1e-20f : best_norm;
    const float qw = __fdiv_rn(best[0], qn), qx = __fdiv_rn(best[1], qn);
    const float qy = __fdiv_rn(best[2], qn), qz = __fdiv_rn(best[3], qn);
    const float R[3][3] = {
        {sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz)))),
         mul(2.0f, sub(mul(qx, qy), mul(qz, qw))), mul(2.0f, add(mul(qx, qz), mul(qy, qw)))},
        {mul(2.0f, add(mul(qx, qy), mul(qz, qw))),
         sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz)))),
         mul(2.0f, sub(mul(qy, qz), mul(qx, qw)))},
        {mul(2.0f, sub(mul(qx, qz), mul(qy, qw))), mul(2.0f, add(mul(qy, qz), mul(qx, qw))),
         sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))))}};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float a = fmaf(R[i][2], mu_s[2], fmaf(R[i][1], mu_s[1], mul(R[i][0], mu_s[0])));
#pragma unroll
        for (int j = 0; j < 3; ++j) T[4 * i + j] = R[i][j];
        T[4 * i + 3] = sub(mu_d[i], a);
    }
}

// One point as the test reads it: src, dst, and the gate's band.
struct Pair {
    float sx, sy, sz, dx, dy, dz, lo, hi, tz;
};

__device__ __forceinline__ Pair load_pair(const float* __restrict__ src,
                                          const float* __restrict__ dst,
                                          const float* __restrict__ keep,
                                          const float* __restrict__ tz, int i) {
    Pair p;
    p.sx = src[3 * i];
    p.sy = src[3 * i + 1];
    p.sz = src[3 * i + 2];
    p.dx = dst[3 * i];
    p.dy = dst[3 * i + 1];
    p.dz = dst[3 * i + 2];
    p.tz = tz[i];
    // |e| < tz is decided on |e|^2 outside [tz^2 (1 - 1e-6), tz^2 (1 + 1e-6)]
    // (wider than the roundings of tz^2 and of the bounds); a point kept
    // out of the count never passes (-1)
    const float t2 = mul(p.tz, p.tz);
    const bool kept = keep[i] > 0.0f;
    p.lo = kept ? mul(t2, 0.999999f) : -1.0f;
    p.hi = kept ? mul(t2, 1.000001f) : -1.0f;
    return p;
}

// |R src + t - dst|^2 at T, with plain's roundings: the matrix product's
// multiply-adds, then + t, - dst, and the squared norm's.
__device__ __forceinline__ float sq_dist(const float* T, const Pair& p) {
    const float e0 = sub(add(fmaf(p.sz, T[2], fmaf(p.sy, T[1], mul(p.sx, T[0]))), T[3]), p.dx);
    const float e1 = sub(add(fmaf(p.sz, T[6], fmaf(p.sy, T[5], mul(p.sx, T[4]))), T[7]), p.dy);
    const float e2 = sub(add(fmaf(p.sz, T[10], fmaf(p.sy, T[9], mul(p.sx, T[8]))), T[11]), p.dz);
    return fmaf(e2, e2, fmaf(e1, e1, mul(e0, e0)));
}

// [|R src + t - dst| < tz and keep > 0] at T: the band of the gate decides
// by the square root.
__device__ __forceinline__ int inlier(const float* T, const Pair& p) {
    const float q = sq_dist(T, p);
    int in = q < p.lo;
    if (!in && q <= p.hi) in = sqrtf(q) < p.tz;
    return in;
}

// Starts copying count floats from global to shared memory (dst 16-byte
// aligned) with cp.async: 16 bytes a copy when src is 16-byte aligned, then
// the ragged tail 4 bytes a copy.  The caller commits and waits.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int count) {
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int nv = count >> 2;
        for (int i = threadIdx.x; i < nv; i += THREADS) {
            const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(s), "l"(src + 4 * i) : "memory");
        }
        head = nv << 2;
    }
    for (int i = head + threadIdx.x; i < count; i += THREADS) {
        const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(s), "l"(src + i) : "memory");
    }
}

// A block's best hypothesis, as every block of the cluster receives it.
struct Best {
    int count, h;
    float T[12];
};

// kStaged: K <= MAX_STAGED, the points copied into shared memory once;
// otherwise read from global memory.  ctas: the cluster's size (1: a plain
// launch, no cluster).
template <bool kStaged>
__global__ void __launch_bounds__(THREADS)
ransac_hyp_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                  const float* __restrict__ keep, const long long* __restrict__ idx,
                  const float* __restrict__ tz, long long* __restrict__ best_out,
                  int* __restrict__ score_out, float* __restrict__ w1, int k, int h,
                  int ctas) {
    extern __shared__ float4 staged4[];
    __shared__ float hyp[ROUND][12];
    __shared__ int counts[ROUND];
    __shared__ Best slots[MAX_CTAS];
    const int rank = ctas > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
    const long long b = blockIdx.x / ctas;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* gsrc = src + b * 3 * k;
    const float* gdst = dst + b * 3 * k;
    const float* gkeep = keep + b * k;
    const float* gtz = tz + b * k;
    const long long* bidx = idx + b * 3 * h;
    __shared__ uint64_t bar;
    if (ctas > 1) {
        // the mbarrier that counts the blocks' bests arriving here
        if (threadIdx.x == 0) {
            mbar_init(&bar);
            mbar_init_fence();
            mbar_expect(&bar, static_cast<unsigned>(ctas * sizeof(Best)));
        }
        cluster_arrive();
    }

    float* staged = reinterpret_cast<float*>(staged4);
    const float* psrc = gsrc;
    const float* pdst = gdst;
    const float* pkeep = gkeep;
    const float* ptz = gtz;
    if (kStaged) {
        float* s_src = staged;
        float* s_dst = s_src + round4(3 * k);
        float* s_tz = s_dst + round4(3 * k);
        float* s_keep = s_tz + round4(k);
        stage(s_src, gsrc, 3 * k);
        stage(s_dst, gdst, 3 * k);
        stage(s_tz, gtz, k);
        stage(s_keep, gkeep, k);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        psrc = s_src;
        pdst = s_dst;
        pkeep = s_keep;
        ptz = s_tz;
    }

    const int per = (h + ctas - 1) / ctas;
    const int h0 = min(h, rank * per), h1 = min(h, h0 + per);
    int best_count = -1, best_h = -1;    // thread 0: this block's best so far
    float best_T[12] = {};
    for (int base = h0; base < h1; base += ROUND) {
        const int n = min(ROUND, h1 - base);
        if (threadIdx.x < n) {
            const long long* i3 = bidx + 3 * static_cast<long long>(base + threadIdx.x);
            float s[3][3], d[3][3];
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                long long i = i3[m];
                i = i < 0 ? 0 : (i >= k ? k - 1 : i);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    s[m][c] = gsrc[3 * i + c];
                    d[m][c] = gdst[3 * i + c];
                }
            }
            qcp3(s, d, hyp[threadIdx.x]);
            counts[threadIdx.x] = 0;
        }
        if (kStaged && base == h0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        // items (group of 4 hypotheses, slice of the points) over the warps
        const int groups = (n + GROUP - 1) / GROUP;
        const int slices = max(1, WARPS / groups);
        for (int item = warp; item < groups * slices; item += WARPS) {
            const int grp = item % groups, slice = item / groups;
            float T[GROUP][12];
#pragma unroll
            for (int m = 0; m < GROUP; ++m) {
                const int j = min(grp * GROUP + m, n - 1);
#pragma unroll
                for (int c = 0; c < 12; ++c) T[m][c] = hyp[j][c];
            }
            int c[GROUP] = {};
            // every lane runs every round (a lane past K tests a point that
            // never passes), so the warp decides together whether any of
            // its tests fell in a gate's band and needs the square root
            for (int base = slice * 32; base < k; base += slices * 32) {
                const int i = base + lane;
                Pair p = load_pair(psrc, pdst, pkeep, ptz, min(i, k - 1));
                if (i >= k) p.lo = p.hi = -1.0f;
                float q[GROUP];
                int in[GROUP];
                bool band = false;
#pragma unroll
                for (int m = 0; m < GROUP; ++m) {
                    q[m] = sq_dist(T[m], p);
                    in[m] = q[m] < p.lo;
                    band = band || (!in[m] && q[m] <= p.hi);
                }
                if (__any_sync(FULL, band)) {
#pragma unroll
                    for (int m = 0; m < GROUP; ++m)
                        if (!in[m] && q[m] <= p.hi) in[m] = sqrtf(q[m]) < p.tz;
                }
#pragma unroll
                for (int m = 0; m < GROUP; ++m) c[m] += in[m];
            }
#pragma unroll
            for (int m = 0; m < GROUP; ++m) {
                const int total = __reduce_add_sync(FULL, c[m]);
                if (lane == 0 && grp * GROUP + m < n) atomicAdd(&counts[grp * GROUP + m], total);
            }
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int j = 0; j < n; ++j)
                if (counts[j] > best_count) {
                    best_count = counts[j];
                    best_h = base + j;
#pragma unroll
                    for (int c = 0; c < 12; ++c) best_T[c] = hyp[j][c];
                }
        }
        __syncthreads();
    }
    if (kStaged && h0 >= h1) {                 // a block with no hypotheses
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
    }

    // every block's best into every block's slot, then one winner
    if (ctas == 1) {
        if (threadIdx.x == 0) {
            slots[0].count = best_count;
            slots[0].h = best_h;
#pragma unroll
            for (int c = 0; c < 12; ++c) slots[0].T[c] = best_T[c];
        }
        __syncthreads();
    } else {
        cluster_wait();                          // every block runs, its mbarrier set
        // thread 0's best goes to block r from lane r of warp 0
        if (threadIdx.x < 32) {
            const int count = __shfl_sync(FULL, best_count, 0);
            const int hbest = __shfl_sync(FULL, best_h, 0);
            float T0v[12];
#pragma unroll
            for (int c = 0; c < 12; ++c) T0v[c] = __shfl_sync(FULL, best_T[c], 0);
            if (threadIdx.x < ctas) {
                const unsigned to = cluster_addr(smem_addr(&slots[rank]), threadIdx.x);
                const unsigned done = cluster_addr(smem_addr(&bar), threadIdx.x);
                st_async(to, static_cast<unsigned>(count), done);
                st_async(to + 4, static_cast<unsigned>(hbest), done);
#pragma unroll
                for (int c = 0; c < 12; ++c)
                    st_async(to + 8 + 4 * c, __float_as_uint(T0v[c]), done);
            }
        }
        mbar_wait(&bar, 0);
    }
    int win = 0;
    for (int r = 1; r < ctas; ++r)
        if (slots[r].count > slots[win].count) win = r;
    float T[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) T[c] = slots[win].T[c];
    float* wb = w1 + b * k;
    for (int i = rank * THREADS + threadIdx.x; i < k; i += ctas * THREADS)
        wb[i] = inlier(T, load_pair(psrc, pdst, pkeep, ptz, i)) ? 1.0f : 0.0f;
    if (rank == 0 && threadIdx.x == 0) {
        best_out[b] = slots[win].h;
        score_out[b] = slots[win].count;
    }
}

// The cluster's size for H hypotheses: one block a HYP_PER_CTA, up to
// MAX_CTAS.
int ctas_for(int h) {
    const int c = (h + HYP_PER_CTA - 1) / HYP_PER_CTA;
    return c < MAX_CTAS ? c : MAX_CTAS;
}

// B problems on a cluster of `ctas` blocks each (1: a plain launch), the
// points staged in shared memory (kStaged; the caller sees that K <=
// MAX_STAGED) or read from memory.
template <bool kStaged>
cudaError_t launch(const float* src, const float* dst, const float* keep,
                   const long long* idx, const float* tz, long long* best,
                   int* score, float* w1, int batch, int k, int h, int ctas,
                   cudaStream_t s) {
    const int smem = kStaged ? staged_bytes(k) : 0;
    if (ctas == 1) {
        ransac_hyp_kernel<kStaged><<<batch, THREADS, smem, s>>>(
            src, dst, keep, idx, tz, best, score, w1, k, h, 1);
        return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(batch) * static_cast<unsigned>(ctas));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, ransac_hyp_kernel<kStaged>, src, dst, keep, idx, tz,
                              best, score, w1, k, h, ctas);
}

}  // namespace

// Lets the staged kernel take MAX_STAGED points' dynamic shared memory
// (above the default 48 KB) and both kernels clusters of 16 blocks.  Called
// once, when the library is loaded, outside any stream capture.  Returns the
// cudaError.
extern "C" int ransac_hyp_setup() {
    cudaError_t err = cudaFuncSetAttribute(ransac_hyp_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           staged_bytes(MAX_STAGED));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(ransac_hyp_kernel<true>,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(ransac_hyp_kernel<false>,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return static_cast<int>(err);
}

// best (B,) int64, score (B,) int32 and w1 (B, K) f32 of B problems of K >= 1
// pairs and H >= 1 samples: the cluster's size from H, the points staged in
// shared memory where they fit (K <= MAX_STAGED), read from memory above.
// Returns the launch's cudaError.
extern "C" int ransac_hyp_launch(const float* src, const float* dst, const float* keep,
                                 const long long* idx, const float* tz, long long* best,
                                 int* score, float* w1, int batch, int k, int h,
                                 void* stream) {
    if (batch < 0 || k < 1 || k > 0x7fffffff / 3 || h < 1 || h > 0x7fffffff / 3 ||
        batch > 0x7fffffff / MAX_CTAS)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    const int ctas = ctas_for(h);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        k <= MAX_STAGED
            ? launch<true>(src, dst, keep, idx, tz, best, score, w1, batch, k, h, ctas, s)
            : launch<false>(src, dst, keep, idx, tz, best, score, w1, batch, k, h, ctas, s);
    return static_cast<int>(err);
}
