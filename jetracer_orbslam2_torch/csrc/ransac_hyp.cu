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
// 0.11 us of the card's peak), but a serial chain: the launch, the load of
// the points and the draws, the solve (30 Newton steps, each a correctly
// rounded division), the tests, the reduction, one exchange between SMs,
// the w1 pass.  The first design (one thread a hypothesis, 256 threads a
// block) took 12.9 us at that shape on an H100; its links, each a launch of
// its own (scripts/bench_torch_k7.py): the empty launch 1.35 us, the gather
// and solve 5.47, the staging 2.35, the tests 6.58, the reduction, exchange
// and w1 pass 4.23.  So this design, link by link:
//   - a problem is split over a thread-block cluster of CTAS blocks of 512
//     threads (CTAS from H: one block a 16 hypotheses, up to 16, a
//     non-portable cluster above 8);
//     block r takes hypotheses [r P, r P + P), P = ceil(H / CTAS), ROUND
//     (32) at a time;
//   - the load: every thread first issues the draws' indices it holds (three
//     lanes a hypothesis) and STAGE points' loads, and the block stores the
//     points into shared memory as records (src, dst and the gate's band, 32
//     bytes a point; K <= MAX_STAGED, a larger K is read from global memory,
//     where it stays in L2); the gather then reads the records: one global
//     round trip before the solve, not two;
//   - the solve: 16 lanes share a hypothesis where its values are
//     independent (the centroids and the correlation, Horn's K and K^2, the
//     16 cofactors, R and t); the Newton steps of the round's hypotheses run
//     on the lanes of one warp, a hypothesis a lane, and stop when every lane
//     repeats bit for bit (checked every NEWTON_CHECK steps: a repeat stays
//     for good, so further steps keep the bits); every value is the plain
//     kabsch_quat's f32 algebra step for step, each product and sum rounded
//     one by one as the plain version's separate kernels round them
//     (sqrt(max(p2, 1e-30)), the |f'| < 1e-20 guard, the longest column,
//     first index on ties, normalised with a 1e-20 clamp);
//   - the tests, with no branch: |e|^2 against tz^2 widened and narrowed by
//     1e-6; only where one of a warp's tests fell within that band of its
//     gate does the warp test those points again with the square root, so
//     each decision is exactly sqrt(|e|^2) < tz.  Points staged: a thread
//     holds HELD hypotheses' T in registers and walks its share of the
//     records (whole warps share a group of hypotheses); points read from
//     memory: a warp holds a slice of 128 points, 4 a lane, and tests GROUP
//     hypotheses at a time, so a point is read once a block.  Counts are
//     integers (a warp reduction a hypothesis, then shared-memory integer
//     atomics), so their order does not matter;
//   - the winner: the block's best is one warp's reduction of a packed
//     (count, -h) key; it goes with its T into every block's shared memory
//     of the cluster by st.async, counted by each block's mbarrier
//     (csrc/cluster.cuh), one-way, with no barrier across the cluster and no
//     block reading another's shared memory; the mbarrier's set-up (its
//     fence took about 1,050 cycles at the kernel's start) runs on warp 1
//     while warp 0 runs the Newton steps; every warp picks the same winner
//     by the same reduction, and each block writes its 1 / CTAS of w1 = the
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

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 16;             // lanes that share a hypothesis' solve
constexpr int ROUND = 32;             // hypotheses a block solves at once
constexpr int HELD = 4;               // hypotheses a thread holds (points staged)
constexpr int PTS = 4;                // points a thread loads at once in the tests
constexpr int SLICE = 32 * PTS;       // points a warp tests at once (read from memory)
constexpr int GROUP = 8;              // hypotheses a warp tests between reductions
constexpr int STAGE = 4;              // points a thread loads before it stores
constexpr int HYP_PER_CTA = 16;       // the cluster's size: a block a 16
constexpr int MAX_CTAS = 16;          // above 8 a non-portable cluster
constexpr int MAX_STAGED = 6144;      // points staged in shared memory
constexpr int NEWTON = 30;
constexpr int NEWTON_CHECK = 6;       // Newton steps between two exit checks
constexpr unsigned FULL = 0xffffffffu;

// dynamic shared memory of a staged block: a record of two float4 a point
__host__ __device__ inline int staged_bytes(int k) { return 32 * k; }

// one rounding a step, as separate PyTorch kernels round: no contraction
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float norm4(float a, float b, float c, float d) {
    return sqrtf(fmaf(d, d, fmaf(c, c, fmaf(b, b, mul(a, a)))));
}

// One point as the tests read it: src, dst and the gate's band, in the
// order of a staged record ({sx, sy, sz, dx}, {dy, dz, lo, hi}).
struct Pair {
    float sx, sy, sz, dx, dy, dz, lo, hi;
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
    // |e| < tz is decided on |e|^2 outside [tz^2 (1 - 1e-6), tz^2 (1 + 1e-6)]
    // (wider than the roundings of tz^2 and of the bounds); a point kept
    // out of the count never passes (-1)
    const float t = tz[i];
    const float t2 = mul(t, t);
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

// [|R src + t - dst| < tz and keep > 0] at T for point i: the band of the
// gate decides by the square root, against the gate read from memory.
__device__ __forceinline__ int inlier(const float* T, const Pair& p,
                                      const float* __restrict__ tz, int i) {
    const float q = sq_dist(T, p);
    int in = q < p.lo;
    if (!in && q <= p.hi) in = sqrtf(q) < tz[i];
    return in;
}

// A block's best hypothesis, as every block of the cluster receives it: the
// key (count << 32 | 0x7fffffff - h; 0 for none) and its T.
struct Best {
    unsigned long long key;
    float T[12];
};

__device__ __forceinline__ unsigned long long best_key(int count, int h) {
    return (static_cast<unsigned long long>(count) << 32) |
           static_cast<unsigned>(0x7fffffff - h);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long key) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(FULL, key, o);
        key = other > key ? other : key;
    }
    return key;
}

// A 16-lane group's scratch in shared memory: K, K^2 and the products of
// the trace powers (then the cofactors) of its hypothesis.
struct Scratch {
    float4 K[4], K2[4], m3[4], m4[4];
};

// The 16 lanes' work before the Newton steps on one hypothesis: its three
// drawn points (lanes 0-2 hold the indices), the centroids (returned in
// every lane) and the centred correlation, Horn's K (left in the group's
// scratch), K^2 and the quartic's coefficients (e2, e3, e4, lam0), which
// lane 0 stores into `newton` if `store`.
template <bool kStaged>
__device__ __forceinline__ void solve_before(const float4* __restrict__ rec,
                                             const float* __restrict__ gsrc,
                                             const float* __restrict__ gdst, int myidx,
                                             Scratch& sc, float4* newton, bool store,
                                             float (&mu_s)[3], float (&mu_d)[3]) {
    const int g = threadIdx.x & (LANES - 1);
    int i3[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) i3[m] = __shfl_sync(FULL, myidx, m, LANES);
    // lane g < 6 (the rest repeat g % 6): column c of src (g < 3) or of dst
    const int col = g % 6, c = col % 3;
    float x[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        if (kStaged)
            x[m] = reinterpret_cast<const float*>(rec)[8 * i3[m] + col];
        else
            x[m] = (col < 3 ? gsrc : gdst)[3 * i3[m] + c];
    }
    const float mu = __fdiv_rn(add(add(x[0], x[1]), x[2]), 3.0f);
    float xc[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) xc[m] = sub(x[m], mu);
    // H[r][q] on lane g < 9 (the rest repeat g % 9): sc[.][r] from lane r,
    // dc[.][q] from lane 3 + q
    const int hr = (g % 9) / 3, hq = (g % 9) % 3;
    float a[3], b[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        a[m] = __shfl_sync(FULL, xc[m], hr, LANES);
        b[m] = __shfl_sync(FULL, xc[m], 3 + hq, LANES);
    }
    const float hg = fmaf(a[2], b[2], fmaf(a[1], b[1], mul(a[0], b[0])));
    float H[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) H[m] = __shfl_sync(FULL, hg, m, LANES);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        mu_s[m] = __shfl_sync(FULL, mu, m, LANES);
        mu_d[m] = __shfl_sync(FULL, mu, 3 + m, LANES);
    }
    const float hxx = H[0], hxy = H[1], hxz = H[2];
    const float hyx = H[3], hyy = H[4], hyz = H[5];
    const float hzx = H[6], hzy = H[7], hzz = H[8];
    const float K[4][4] = {
        {add(add(hxx, hyy), hzz), sub(hyz, hzy), sub(hzx, hxz), sub(hxy, hyx)},
        {sub(hyz, hzy), sub(sub(hxx, hyy), hzz), add(hxy, hyx), add(hzx, hxz)},
        {sub(hzx, hxz), add(hxy, hyx), sub(add(-hxx, hyy), hzz), add(hyz, hzy)},
        {sub(hxy, hyx), add(hzx, hxz), add(hyz, hzy), add(sub(-hxx, hyy), hzz)}};
    if (g == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) sc.K[r] = make_float4(K[r][0], K[r][1], K[r][2], K[r][3]);
    }
    __syncwarp();
    // K^2[i][j] on lane g = 4 i + j; K is symmetric bit for bit (its
    // entries mirror one expression), so column j of K is its row j
    const int ki = g >> 2, kj = g & 3;
    const float4 ri = sc.K[ki], rj = sc.K[kj];
    const float k2 = fmaf(ri.w, rj.w, fmaf(ri.z, rj.z, fmaf(ri.y, rj.y, mul(ri.x, rj.x))));
    // K^2 is symmetric too (the same products in the same order), so
    // K^2[j][i] = k2 and K[j][i] = K[i][j]
    const float kij = kj == 0 ? ri.x : kj == 1 ? ri.y : kj == 2 ? ri.z : ri.w;
    reinterpret_cast<float*>(sc.K2)[g] = k2;
    reinterpret_cast<float*>(sc.m3)[g] = mul(k2, kij);
    reinterpret_cast<float*>(sc.m4)[g] = mul(k2, k2);
    __syncwarp();
    float k2d[4], m3[16], m4[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const float4 v = sc.K2[r];
        k2d[r] = r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
        const float4 u = sc.m3[r], w = sc.m4[r];
        m3[4 * r] = u.x, m3[4 * r + 1] = u.y, m3[4 * r + 2] = u.z, m3[4 * r + 3] = u.w;
        m4[4 * r] = w.x, m4[4 * r + 1] = w.y, m4[4 * r + 2] = w.z, m4[4 * r + 3] = w.w;
    }
    const float p2 = add(add(add(k2d[0], k2d[1]), k2d[2]), k2d[3]);
    float p3 = 0.0f, p4 = 0.0f;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
        p3 = add(p3, m3[m]);
        p4 = add(p4, m4[m]);
    }
    const float e2 = mul(-0.5f, p2);
    const float e3 = __fdiv_rn(p3, 3.0f);
    const float e4 = mul(sub(mul(mul(0.5f, p2), p2), p4), 0.25f);
    // torch.clamp_min keeps a NaN, fmaxf would not
    const float lam = sqrtf(p2 < 1e-30f ? 1e-30f : p2);
    if (store && g == 0) *newton = make_float4(e2, e3, e4, lam);
}

// One Newton step on the quartic lam^4 + e2 lam^2 - e3 lam + e4.
__device__ __forceinline__ float newton_step(float lam, float e2, float neg_e3, float e4,
                                             float two_e2) {
    float f = fmaf(lam, lam, e2);
    f = fmaf(f, lam, neg_e3);
    f = fmaf(f, lam, e4);
    float fp = fmaf(mul(4.0f, lam), lam, two_e2);
    fp = fmaf(fp, lam, neg_e3);
    fp = fabsf(fp) < 1e-20f ? 1e-20f : fp;
    return sub(lam, __fdiv_rn(f, fp));
}

// The NEWTON steps of one hypothesis a lane from (e2, e3, e4, lam0), all
// lanes of the warp together.  A step is a function of lam alone, so once
// lam repeats bit for bit it stays for good: a lane at such a fixed point
// keeps its bits through further steps, and the warp stops when every lane
// is at one (checked every NEWTON_CHECK steps) or after NEWTON steps, with
// the plain loop's lam in every lane.
__device__ __forceinline__ float newton_root(float4 in) {
    static_assert(NEWTON % NEWTON_CHECK == 0, "whole runs of steps between checks");
    const float e2 = in.x, neg_e3 = -in.y, e4 = in.z, two_e2 = mul(2.0f, e2);
    float lam = in.w;
    for (int it = 0; it < NEWTON; it += NEWTON_CHECK) {
        float prev = lam;
#pragma unroll
        for (int s = 0; s < NEWTON_CHECK; ++s) {
            prev = lam;
            lam = newton_step(lam, e2, neg_e3, e4, two_e2);
        }
        if (!__any_sync(FULL, __float_as_uint(lam) != __float_as_uint(prev))) break;
    }
    return lam;
}

// The 16 lanes' work after the Newton steps: the cofactor (row j, column i)
// of A = K - lam I on lane g = 4 j + i, then on every lane the column norms,
// the longest column (first on ties), q, R and t; lane 0 stores T (three
// rows of [R | t]) if `store`.
__device__ __forceinline__ void solve_after(Scratch& sc, float lam, const float (&mu_s)[3],
                                            const float (&mu_d)[3], float4* T, bool store) {
    const int g = threadIdx.x & (LANES - 1);
    const int j = g >> 2, i = g & 3;
    // the minor without row j and column i, expanded as
    // geometry._adjugate_columns expands it
    const int r[3] = {j == 0 ? 1 : 0, j <= 1 ? 2 : 1, j <= 2 ? 3 : 2};
    const int c[3] = {i == 0 ? 1 : 0, i <= 1 ? 2 : 1, i <= 2 ? 3 : 2};
    float m[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float4 row = sc.K[r[a]];
        const float v[3] = {i == 0 ? row.y : row.x, i <= 1 ? row.z : row.y,
                            i <= 2 ? row.w : row.z};
#pragma unroll
        for (int b = 0; b < 3; ++b) m[a][b] = sub(v[b], mul(lam, r[a] == c[b] ? 1.0f : 0.0f));
    }
    const float ma = mul(m[0][0], sub(mul(m[1][1], m[2][2]), mul(m[1][2], m[2][1])));
    const float mb = mul(m[0][1], sub(mul(m[1][0], m[2][2]), mul(m[1][2], m[2][0])));
    const float md = mul(m[0][2], sub(mul(m[1][0], m[2][1]), mul(m[1][1], m[2][0])));
    const float cof = mul(((i + j) & 1) ? -1.0f : 1.0f, add(sub(ma, mb), md));
    reinterpret_cast<float*>(sc.m3)[g] = cof;
    __syncwarp();
    // row j of the cofactors is column j of adj(A); the longest, first on ties
    float best[4], best_norm = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 v = sc.m3[q];
        const float n = norm4(v.x, v.y, v.z, v.w);
        if (q == 0 || n > best_norm) {
            best_norm = n;
            best[0] = v.x, best[1] = v.y, best[2] = v.z, best[3] = v.w;
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
    float t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        t[a] = sub(mu_d[a], fmaf(R[a][2], mu_s[2], fmaf(R[a][1], mu_s[1], mul(R[a][0], mu_s[0]))));
    if (store && g == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) T[a] = make_float4(R[a][0], R[a][1], R[a][2], t[a]);
    }
}

// A block's shared memory besides the staged points.
struct Shared {
    float4 hyp[ROUND][3];        // the round's hypotheses: rows of [R | t]
    float4 newton[ROUND];        // their (e2, e3, e4, lam0)
    float lams[ROUND];           // their Newton roots
    int counts[ROUND];           // their inlier counts
    Scratch scratch[ROUND];      // a 16-lane group's scratch each
    Best slots[MAX_CTAS];        // every block's best, by rank
    uint64_t bar;                // counts the bests arriving
};

// The problem's rows and this block's place in its cluster.
struct Problem {
    const float *src, *dst, *keep, *tz;
    const long long* idx;
    int k, h, rank, ctas;
};

// ctas > 1: thread 0 of warp 1 sets the mbarrier that counts the blocks'
// bests arriving here and fences its initialisation, and every thread
// arrives at the cluster barrier, relaxed (its wait, before the first
// st.async, acquires).  Called where warp 1 waits for warp 0 anyway (the
// Newton steps): the fence is slow.
__device__ __forceinline__ void exchange_init(Shared& sm, int ctas) {
    if (ctas == 1) return;
    if (threadIdx.x == 32) {
        mbar_init(&sm.bar);
        mbar_init_fence();
        mbar_expect(&sm.bar, static_cast<unsigned>(ctas * sizeof(Best)));
    }
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// Lanes 0-2 of the 16-lane group of slot `slot`: the draw's index (clamped
// into [0, K)), 0 elsewhere and for a slot past n.
__device__ __forceinline__ int drawn(const Problem& pb, int base, int n) {
    const int slot = threadIdx.x / LANES, g = threadIdx.x & (LANES - 1);
    if (g >= 3 || slot >= n) return 0;
    const long long i = pb.idx[3 * static_cast<long long>(base + slot) + g];
    return static_cast<int>(i < 0 ? 0 : (i >= pb.k ? pb.k - 1 : i));
}

// Point i from its staged record, or from memory.
__device__ __forceinline__ Pair staged_pair(const float4* __restrict__ rec, int i) {
    const float4 a = rec[2 * i], b = rec[2 * i + 1];
    return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

template <bool kStaged>
__device__ __forceinline__ Pair pair_at(const float4* __restrict__ rec, const Problem& pb,
                                        int i) {
    return kStaged ? staged_pair(rec, i) : load_pair(pb.src, pb.dst, pb.keep, pb.tz, i);
}

// Every point into its record in shared memory (the caller syncs): STAGE
// points a thread loaded before any is stored, so their loads fly together.
__device__ __forceinline__ void stage_records(float4* __restrict__ rec, const Problem& pb) {
    for (int i0 = threadIdx.x; i0 < pb.k; i0 += STAGE * THREADS) {
        Pair p[STAGE];
#pragma unroll
        for (int u = 0; u < STAGE; ++u)
            p[u] = load_pair(pb.src, pb.dst, pb.keep, pb.tz, min(i0 + u * THREADS, pb.k - 1));
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
            const int i = i0 + u * THREADS;
            if (i < pb.k) {
                rec[2 * i] = make_float4(p[u].sx, p[u].sy, p[u].sz, p[u].dx);
                rec[2 * i + 1] = make_float4(p[u].dy, p[u].dz, p[u].lo, p[u].hi);
            }
        }
    }
}

// The round's n hypotheses into sm.hyp, from the indices in `myidx`
// (drawn): a warp solves slots 2 warp and 2 warp + 1 (a slot past n repeats
// slot n - 1 and stores nothing), warp 0 runs their Newton steps (a lane
// past n repeats lane n - 1) while the others, in the first round
// (`first`), set up the exchange.  Starts and ends with the block in step.
template <bool kStaged>
__device__ __forceinline__ void solve_round(Shared& sm, const float4* __restrict__ rec,
                                            const Problem& pb, int myidx, int n, bool first) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slot = threadIdx.x / LANES, g = threadIdx.x & (LANES - 1);
    float mu_s[3], mu_d[3];
    const bool solves = 2 * warp < n;
    const int s = min(slot, n - 1);
    if (solves) {
        myidx = __shfl_sync(FULL, myidx, (s % 2) * LANES + g);
        solve_before<kStaged>(rec, pb.src, pb.dst, myidx, sm.scratch[slot], &sm.newton[slot],
                              slot < n, mu_s, mu_d);
    }
    __syncthreads();
    if (warp == 0) {
        const float lam = newton_root(sm.newton[min(lane, n - 1)]);
        if (lane < n) sm.lams[lane] = lam;
    }
    if (first) exchange_init(sm, pb.ctas);
    __syncthreads();
    if (solves) solve_after(sm.scratch[slot], sm.lams[s], mu_s, mu_d, sm.hyp[slot], slot < n);
    __syncthreads();
}

__device__ __forceinline__ void load_T(const Shared& sm, int j, float (&T)[12]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float4 v = sm.hyp[j][a];
        T[4 * a] = v.x, T[4 * a + 1] = v.y, T[4 * a + 2] = v.z, T[4 * a + 3] = v.w;
    }
}

// The round's n hypotheses against every point, into sm.counts (zeroed
// before).  The tests have no branch (|e|^2 against the band's lower
// bound); only where one of a warp's tests fell within a gate's band does
// the warp test those points again exactly.  A count is an integer: a warp
// reduction a hypothesis, then a shared-memory atomic.
//
// Points staged: the threads in whole warps a group of HELD hypotheses,
// whose T a thread holds in registers while it walks its share of the
// records, PTS at a time (a hypothesis past n repeats n - 1 and adds
// nothing); a record is read again by every group, from shared memory.
__device__ __forceinline__ void test_held(Shared& sm, const float4* __restrict__ rec,
                                          const Problem& pb, int n) {
    const int lane = threadIdx.x & 31, k = pb.k;
    const int groups = (n + HELD - 1) / HELD;
    const int share = max(32, (THREADS / groups) & ~31);     // threads a group
    const int grp = threadIdx.x / share, first = threadIdx.x % share;
    if (grp < groups) {                          // whole warps
        float T[HELD][12];
#pragma unroll
        for (int u = 0; u < HELD; ++u) load_T(sm, min(grp * HELD + u, n - 1), T[u]);
        int cnt[HELD] = {};
        bool band = false;
        for (int i0 = first; i0 < k; i0 += PTS * share) {
            Pair p[PTS];
#pragma unroll
            for (int m = 0; m < PTS; ++m) {
                const int i = i0 + m * share;
                p[m] = staged_pair(rec, min(i, k - 1));
                if (i >= k) p[m].lo = p[m].hi = -1.0f;
            }
#pragma unroll
            for (int m = 0; m < PTS; ++m)
#pragma unroll
                for (int u = 0; u < HELD; ++u) {
                    const float q = sq_dist(T[u], p[m]);
                    const bool in = q < p[m].lo;
                    cnt[u] += in;
                    band |= !in & (q <= p[m].hi);
                }
        }
        if (__any_sync(FULL, band)) {
#pragma unroll
            for (int u = 0; u < HELD; ++u) cnt[u] = 0;
            for (int i = first; i < k; i += share) {
                const Pair p = staged_pair(rec, i);
#pragma unroll
                for (int u = 0; u < HELD; ++u) cnt[u] += inlier(T[u], p, pb.tz, i);
            }
        }
#pragma unroll
        for (int u = 0; u < HELD; ++u) {
            const int j = grp * HELD + u;
            const int total = __reduce_add_sync(FULL, cnt[u]);
            if (lane == 0 && j < n) atomicAdd(&sm.counts[j], total);
        }
    }
}

// Points read from memory: items (a subset of the hypotheses, a slice of
// SLICE points, PTS a lane) over the warps, so a point is read once a block
// and tested against GROUP hypotheses between two reductions (one past n
// repeats n - 1 and adds nothing).
__device__ __forceinline__ void test_items(Shared& sm, const Problem& pb, int n) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int k = pb.k;
    const int slices = (k + SLICE - 1) / SLICE;
    const int subsets = max(1, min(n, WARPS / slices));
    for (int item = warp; item < slices * subsets; item += WARPS) {
        const int sl = item % slices, first = item / slices;
        Pair p[PTS];
        int pi[PTS];
#pragma unroll
        for (int m = 0; m < PTS; ++m) {
            pi[m] = min(sl * SLICE + m * 32 + lane, k - 1);
            p[m] = load_pair(pb.src, pb.dst, pb.keep, pb.tz, pi[m]);
            if (sl * SLICE + m * 32 + lane >= k) p[m].lo = p[m].hi = -1.0f;
        }
        for (int j0 = first; j0 < n; j0 += GROUP * subsets) {
            int cnt[GROUP];
            bool band = false;
#pragma unroll
            for (int u = 0; u < GROUP; ++u) {
                float T[12];
                load_T(sm, min(j0 + u * subsets, n - 1), T);
                cnt[u] = 0;
#pragma unroll
                for (int m = 0; m < PTS; ++m) {
                    const float q = sq_dist(T, p[m]);
                    const bool in = q < p[m].lo;
                    cnt[u] += in;
                    band |= !in & (q <= p[m].hi);
                }
            }
            if (__any_sync(FULL, band)) {
#pragma unroll
                for (int u = 0; u < GROUP; ++u) {
                    float T[12];
                    load_T(sm, min(j0 + u * subsets, n - 1), T);
                    cnt[u] = 0;
#pragma unroll
                    for (int m = 0; m < PTS; ++m) cnt[u] += inlier(T, p[m], pb.tz, pi[m]);
                }
            }
#pragma unroll
            for (int u = 0; u < GROUP; ++u) {
                const int j = j0 + u * subsets;
                const int total = __reduce_add_sync(FULL, cnt[u]);
                if (lane == 0 && j < n) atomicAdd(&sm.counts[j], total);
            }
        }
    }
}

// The tests of one round; ends with the block in step.
template <bool kStaged>
__device__ __forceinline__ void test_round(Shared& sm, const float4* __restrict__ rec,
                                           const Problem& pb, int n) {
    if (kStaged)
        test_held(sm, rec, pb, n);
    else
        test_items(sm, pb, n);
    __syncthreads();
}

// Warp 0: the round's best key (hypotheses base..base + n - 1) into
// best_k and its T into best_T where it beats them.
__device__ __forceinline__ void round_best(const Shared& sm, int base, int n,
                                           unsigned long long& best_k, float4 (&best_T)[3]) {
    const int lane = threadIdx.x & 31;
    const unsigned long long key = lane < n ? best_key(sm.counts[lane], base + lane) : 0ull;
    const unsigned long long top = warp_max(key);
    if (top > best_k) {
        best_k = top;
        const int j = 0x7fffffff - static_cast<int>(top & 0xffffffffu) - base;
#pragma unroll
        for (int a = 0; a < 3; ++a) best_T[a] = sm.hyp[j][a];
    }
}

// Every block's best (warp 0's best_k, best_T) into every block's slot, one
// winner in every warp, this block's share of w1 and, from rank 0, best and
// score of problem b.
template <bool kStaged>
__device__ __forceinline__ void finish(Shared& sm, const float4* __restrict__ rec,
                                       const Problem& pb, unsigned long long best_k,
                                       const float4 (&best_T)[3], long long b,
                                       long long* __restrict__ best_out,
                                       int* __restrict__ score_out, float* __restrict__ w1) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rank = pb.rank, ctas = pb.ctas, k = pb.k;
    if (ctas == 1) {
        if (threadIdx.x == 0) {
            sm.slots[0].key = best_k;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                sm.slots[0].T[4 * a] = best_T[a].x, sm.slots[0].T[4 * a + 1] = best_T[a].y;
                sm.slots[0].T[4 * a + 2] = best_T[a].z, sm.slots[0].T[4 * a + 3] = best_T[a].w;
            }
        }
        __syncthreads();
    } else {
        cluster_wait();                          // every block runs, its mbarrier set
        // warp 0's best goes to block r from lane r
        if (warp == 0 && lane < ctas) {
            const unsigned to = cluster_addr(smem_addr(&sm.slots[rank]), lane);
            const unsigned done = cluster_addr(smem_addr(&sm.bar), lane);
            st_async(to, __longlong_as_double(static_cast<long long>(best_k)), done);
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                st_async(to + 8 + 16 * a,
                         __hiloint2double(__float_as_int(best_T[a].y), __float_as_int(best_T[a].x)),
                         done);
                st_async(to + 16 + 16 * a,
                         __hiloint2double(__float_as_int(best_T[a].w), __float_as_int(best_T[a].z)),
                         done);
            }
        }
        mbar_wait(&sm.bar, 0);
    }
    // the winner: the largest key, in every warp alike
    const unsigned long long mine = lane < ctas ? sm.slots[lane].key : 0ull;
    const unsigned long long top = warp_max(mine);
    const int win = __ffs(__ballot_sync(FULL, lane < ctas && mine == top)) - 1;
    float T[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) T[c] = sm.slots[win].T[c];
    // this block's share of w1
    const int share = (k + ctas - 1) / ctas;
    const int i0 = min(k, rank * share), i1 = min(k, i0 + share);
    float* wb = w1 + b * k;
    for (int i = i0 + threadIdx.x; i < i1; i += THREADS)
        wb[i] = inlier(T, pair_at<kStaged>(rec, pb, i), pb.tz, i) ? 1.0f : 0.0f;
    if (rank == 0 && threadIdx.x == 0) {
        best_out[b] = 0x7fffffff - static_cast<int>(top & 0xffffffffu);
        score_out[b] = static_cast<int>(top >> 32);
    }
}

// The chain's links end where mark(i) is called: 0 the load (the draws'
// indices, the records, the counts), 1 the solve, 2 the tests, 3 the
// block's best, 4 the exchange and the w1 pass; a round calls 0-3 once.
// The kernel marks nothing; scripts/bench_torch_k7.py times its links with
// a mark that reads clock64.
struct NoMarks {
    __device__ __forceinline__ void operator()(int) const {}
};

// Problem b = blockIdx.x / ctas, this block's share of it: kStaged, K <=
// MAX_STAGED, the points stored in shared memory once as records; otherwise
// read from global memory.  ctas: the cluster's size (1: a plain launch, no
// cluster).
template <bool kStaged, class Marks>
__device__ __forceinline__ void select_block(
    Shared& sm, float4* rec, const float* __restrict__ src,
    const float* __restrict__ dst, const float* __restrict__ keep,
    const long long* __restrict__ idx, const float* __restrict__ tz,
    long long* __restrict__ best_out, int* __restrict__ score_out, float* __restrict__ w1,
    int k, int h, int ctas, Marks& mark) {
    const long long b = blockIdx.x / ctas;
    const Problem pb = {src + b * 3 * k, dst + b * 3 * k, keep + b * k, tz + b * k,
                        idx + b * 3 * h, k, h,
                        ctas > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0,
                        ctas};
    const int per = (h + ctas - 1) / ctas;
    const int h0 = min(h, pb.rank * per), h1 = min(h, h0 + per);
    // the first round's indices before the points: their loads fly together
    int myidx = drawn(pb, h0, min(ROUND, h1 - h0));
    if (kStaged) stage_records(rec, pb);
    // this block's best so far, in every lane of warp 0
    unsigned long long best_k = 0;
    float4 best_T[3] = {};
    for (int base = h0; base < h1; base += ROUND) {
        const int n = min(ROUND, h1 - base);
        if (base != h0) myidx = drawn(pb, base, n);
        if (threadIdx.x < ROUND) sm.counts[threadIdx.x] = 0;
        __syncthreads();                         // the records, the counts
        mark(0);
        solve_round<kStaged>(sm, rec, pb, myidx, n, base == h0);
        mark(1);
        test_round<kStaged>(sm, rec, pb, n);
        mark(2);
        if ((threadIdx.x >> 5) == 0) round_best(sm, base, n, best_k, best_T);
        __syncthreads();                         // hyp and counts free again
        mark(3);
    }
    if (h0 >= h1) {                              // a block with no hypotheses
        exchange_init(sm, ctas);
        __syncthreads();
    }
    finish<kStaged>(sm, rec, pb, best_k, best_T, b, best_out, score_out, w1);
    mark(4);
}

template <bool kStaged>
__global__ void __launch_bounds__(THREADS, 1)
ransac_hyp_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                  const float* __restrict__ keep, const long long* __restrict__ idx,
                  const float* __restrict__ tz, long long* __restrict__ best_out,
                  int* __restrict__ score_out, float* __restrict__ w1, int k, int h,
                  int ctas) {
    extern __shared__ float4 rec[];
    __shared__ Shared sm;
    NoMarks none;
    select_block<kStaged>(sm, rec, src, dst, keep, idx, tz, best_out, score_out, w1, k, h,
                          ctas, none);
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
    if (batch < 0 || k < 1 || k > 0x7fffffff / 8 || h < 1 || h > 0x7fffffff / 3 ||
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
