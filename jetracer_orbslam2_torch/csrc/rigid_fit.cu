// Weighted rigid fit (Kabsch) for sm_90a, K5: B problems of N point pairs,
// src, dst (B, N, 3) f32 and weights (B, N) f32 (or none: all 1), to (B, 4, 4)
// f32 transforms T with dst ~= T @ src.  Two entries share the code:
//   rigid_fit_launch    one fit a problem;
//   rigid_refit_launch  the refit pair of RANSAC and of the SLAM map refit in
//                       one launch: T1 = fit(w1), rounded to f32; residuals
//                       r = |T1 src - dst| (src @ R^T + t, as
//                       geometry.transform_points); w2 = keep * [r < gate];
//                       T2 = fit(w2); n = count of nonzero w2.
//
// Replaces no TPU kernel: the JAX package computes kabsch with
// jnp.linalg.svd (jetracer_orbslam2_tpu/ops/geometry.py::kabsch), outside any
// Pallas kernel.  On the card the port's plain route, torch.linalg.svd, makes
// the host wait (cuSOLVER's info check reads the device back), so a frame
// step that refits with it cannot be captured into a CUDA graph.  K5 computes
// the same transform with no host wait and no allocation.
//
// What bounds it: not bytes (B 1, N 1,024 reads 28 KB, 8.6 ns at 3.35 TB/s)
// nor operations (about 40,000), but latency: the launch (about 1.2 us), the
// load, the block's reduction, and one thread's factorisation of a 3 x 3,
// a chain of dependent f64 operations.  Measured on this kernel's first
// design (H100, B 1, N 1,024): 11.7 us a launch, of which the factorisation
// alone (one-sided Jacobi, 8 fixed sweeps, each rotation a sqrt, a hypot, two
// divisions) took 9.2 us and the two-pass reduction alone 3.9 us
// (scripts/bench_torch_k5.py).  So the design shortens each chain:
//   - the problem comes into shared memory once, by cp.async copies all in
//     flight together (16 bytes a copy, coalesced; 4 bytes where an address
//     is not 16-byte aligned, and for the ragged tail): one trip to memory,
//     where a loop of loads waits for each in turn;
//   - one pass sums the 16 moments (sum w, sum w s, sum w d, sum w s d^T) in
//     f64, and ONE fixed-order reduction adds them: a reduce-scatter of
//     warp shuffles (16 values in 16 shuffles a lane, not 80), then the four
//     warps' partials added in warp order by the thread that factors.  No
//     atomics: a relaunch and a graph replay give the same bits;
//   - H = sum w s d^T - (sum w s) mu_d^T, and the rotation is the top
//     eigenvector of Horn's 4 x 4 K(H) (QCP, the algebra of the port's
//     geometry.kabsch_quat): Newton on the characteristic quartic from the
//     upper bound sqrt(3/4 tr K^2) = sqrt(3) |H|_F, with a convergence exit
//     (a few steps for a well-posed fit; 50 at most, where a near-double root
//     converges only linearly), then the largest-norm row of
//     adj(K - lambda I).  A quaternion gives a proper rotation by
//     construction: no det guard;
//   - a repeated top eigenvalue (collinear points, a single point, all
//     weights 0) leaves adj(K - lambda I) ~ 0; then any unit vector of the
//     null space of K - lambda I is optimal, and the branch takes the axis
//     least covered by that matrix's row space, projected off it.  All
//     weights 0 (H = 0) gives exactly I;
//   - the refit pair shares the loaded points: fit, residual pass, fit, in
//     one launch, where the two-call route paid two launches and about seven
//     small kernels between them; keep and the gate are copied in while the
//     first fit runs.
//
// Cancellation: the moments are taken about the origin, not the centroid.
// The products w s d are summed in f64 (the f32 inputs and w s are exact in
// f64), each thread over its N / 128 points, then in a tree of depth 7, so
// each entry of sum w s d^T and of (sum w s) mu_d^T is within
// (N / 128 + 9) u sum w |s| |d| of exact (u = 2^-53).  H's error relative to
// |H| is thus about (N / 128 + 9) u (D / sigma)^2, with D the points'
// distance from the origin and sigma their spread: 1e-11 at D / sigma = 100
// (world points tens of metres out, spread over metres), far below the
// 1e-5 the kernel is held to.
//
// Layout: one block of 128 threads a problem, B blocks.  Two paths, chosen
// by N at the launch, with the same arithmetic in the same order:
//   - N <= MAX_N = 6144 (the staged path): the problem in shared memory, src
//     and dst (12 N bytes each, rounded up to 16) and the weights (4 N
//     bytes); the refit's w1, keep and a gate a point (12 N bytes): 221,184
//     bytes at MAX_N, within the 227 KB a block may take;
//   - N > MAX_N (the streamed path): no copy; each pass reads the points
//     from global memory a tile of 128 points at a time, thread i taking
//     points i, i + 128, ...: the fit's moments in one pass, the refit's
//     first fit in one and its residual gate with the second fit's moments
//     in a second, which reads the points again instead of keeping them.
//     The reduction is the staged path's (thread, warp shuffle tree, warps
//     in warp order, no atomics), so relaunches and replays repeat bit for
//     bit at any N.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NMOM = 16;           // moments of one fit
constexpr int MAX_N = 6144;        // points of the staged path (9 floats each in smem)
constexpr int NEWTON_MAX = 50;
constexpr unsigned FULL = 0xffffffffu;

// Floats up to a multiple of 4: each shared array starts 16-byte aligned.
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory of one problem, bytes: src and dst, and `arrays`
// more per-point arrays (the fit's weights; the refit's w1, keep, gate).
__host__ __device__ inline int smem_bytes(int n, int arrays) {
    return 4 * (2 * round4(3 * n) + arrays * round4(n));
}

// ---- factorisation (one thread) -------------------------------------------

// The 2 x 2 minors of rows 0-1 (s) and rows 2-3 (c) of a 4 x 4.
struct Minors {
    double s0, s1, s2, s3, s4, s5, c0, c1, c2, c3, c4, c5;
};

__device__ __forceinline__ Minors minors4(const double (&a)[4][4]) {
    Minors m;
    m.s0 = a[0][0] * a[1][1] - a[1][0] * a[0][1];
    m.s1 = a[0][0] * a[1][2] - a[1][0] * a[0][2];
    m.s2 = a[0][0] * a[1][3] - a[1][0] * a[0][3];
    m.s3 = a[0][1] * a[1][2] - a[1][1] * a[0][2];
    m.s4 = a[0][1] * a[1][3] - a[1][1] * a[0][3];
    m.s5 = a[0][2] * a[1][3] - a[1][2] * a[0][3];
    m.c5 = a[2][2] * a[3][3] - a[3][2] * a[2][3];
    m.c4 = a[2][1] * a[3][3] - a[3][1] * a[2][3];
    m.c3 = a[2][1] * a[3][2] - a[3][1] * a[2][2];
    m.c2 = a[2][0] * a[3][3] - a[3][0] * a[2][3];
    m.c1 = a[2][0] * a[3][2] - a[3][0] * a[2][2];
    m.c0 = a[2][0] * a[3][1] - a[3][0] * a[2][1];
    return m;
}

__device__ __forceinline__ double dot4(const double (&x)[4], const double (&y)[4]) {
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2] + x[3] * y[3];
}

// Keeps x in best (and its squared norm in best_n2) if it is strictly
// longer: the first of equal rows wins.
__device__ __forceinline__ void keep_longest(const double (&x)[4], double (&best)[4],
                                             double& best_n2) {
    const double n2 = dot4(x, x);
    if (n2 > best_n2) {
        best_n2 = n2;
        for (int k = 0; k < 4; ++k) best[k] = x[k];
    }
}

// A unit vector of the null space of the symmetric a (rank <= 2, a repeated
// top eigenvalue): u, v an orthonormal basis of the row space (the longest
// row, then the longest of the rest with u projected off), q the axis least
// covered by them with u and v projected off.  a = 0 gives q = e_0.
__device__ void null_vector(const double (&a)[4][4], double (&q)[4]) {
    double u[4] = {0.0, 0.0, 0.0, 0.0}, u_n2 = 0.0;
    for (int r = 0; r < 4; ++r) keep_longest(a[r], u, u_n2);
    if (u_n2 > 0.0) {
        const double inv = 1.0 / sqrt(u_n2);
        for (int k = 0; k < 4; ++k) u[k] *= inv;
    }
    double v[4] = {0.0, 0.0, 0.0, 0.0}, v_n2 = 0.0;
    for (int r = 0; r < 4; ++r) {
        const double d = dot4(a[r], u);
        double x[4];
        for (int k = 0; k < 4; ++k) x[k] = a[r][k] - d * u[k];
        keep_longest(x, v, v_n2);
    }
    if (v_n2 > 1e-20 * u_n2 && v_n2 > 0.0) {
        const double inv = 1.0 / sqrt(v_n2);
        for (int k = 0; k < 4; ++k) v[k] *= inv;
    } else {
        for (int k = 0; k < 4; ++k) v[k] = 0.0;
    }
    int axis = 0;
    double cover = u[0] * u[0] + v[0] * v[0];
    for (int k = 1; k < 4; ++k) {
        const double c = u[k] * u[k] + v[k] * v[k];
        if (c < cover) {
            cover = c;
            axis = k;
        }
    }
    double ua = 0.0, va = 0.0;
    for (int k = 0; k < 4; ++k)
        if (k == axis) {
            ua = u[k];
            va = v[k];
        }
    for (int k = 0; k < 4; ++k) q[k] = (k == axis ? 1.0 : 0.0) - ua * u[k] - va * v[k];
}

// The 16 moments m of one fit -> R (row-major) and t, in f64.
//   m[0] = sum w;  m[1..3] = sum w s;  m[4..6] = sum w d;
//   m[7 + 3 i + j] = sum w s_i d_j.
__device__ void solve(const double (&m)[NMOM], double (&R)[3][3], double (&t)[3]) {
    const double inv_w = 1.0 / fmax(m[0], 1e-9);
    double mu_s[3], mu_d[3], h[3][3];
    for (int r = 0; r < 3; ++r) {
        mu_s[r] = m[1 + r] * inv_w;
        mu_d[r] = m[4 + r] * inv_w;
    }
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) h[i][j] = m[7 + 3 * i + j] - m[1 + i] * mu_d[j];
    const double hxx = h[0][0], hxy = h[0][1], hxz = h[0][2];
    const double hyx = h[1][0], hyy = h[1][1], hyz = h[1][2];
    const double hzx = h[2][0], hzy = h[2][1], hzz = h[2][2];
    // Horn's K: q rotates src onto dst
    double a[4][4] = {
        {hxx + hyy + hzz, hyz - hzy, hzx - hxz, hxy - hyx},
        {hyz - hzy, hxx - hyy - hzz, hxy + hyx, hzx + hxz},
        {hzx - hxz, hxy + hyx, -hxx + hyy - hzz, hyz + hzy},
        {hxy - hyx, hzx + hxz, hyz + hzy, -hxx - hyy + hzz}};
    // det(x I - K) = x^4 + e2 x^2 - e3 x + e4 (K is traceless)
    double hh = 0.0;
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) hh += h[i][j] * h[i][j];
    const double e2 = -2.0 * hh;
    const double e3 = 8.0 * (hxx * (hyy * hzz - hyz * hzy) - hxy * (hyx * hzz - hyz * hzx) +
                             hxz * (hyx * hzy - hyy * hzx));
    Minors mk = minors4(a);
    const double e4 = mk.s0 * mk.c5 - mk.s1 * mk.c4 + mk.s2 * mk.c3 + mk.s3 * mk.c2 -
                      mk.s4 * mk.c1 + mk.s5 * mk.c0;
    // Newton from above: f is increasing and convex right of the top root
    // (f'' = 12 x^2 - tr K^2 >= 0 there, as lambda_max^2 >= tr K^2 / 12).
    // The start is an upper bound: the eigenvalues sum to 0, so
    // lambda_max^2 <= 3/4 tr K^2 = 3 |H|_F^2, with equality when the other
    // three are equal (a noiseless fit of points spread alike on every axis)
    const double lam0 = sqrt(3.0 * hh);
    double lam = lam0;
    for (int it = 0; it < NEWTON_MAX; ++it) {
        const double l2 = lam * lam;
        const double f = ((l2 + e2) * lam - e3) * lam + e4;
        const double fp = (4.0 * l2 + 2.0 * e2) * lam - e3;
        if (!(fp > 0.0)) break;                 // H = 0, or lambda on a root
        const double step = f / fp;
        lam -= step;
        if (fabs(step) <= 1e-11 * lam) break;
    }
    for (int k = 0; k < 4; ++k) a[k][k] -= lam;
    // the longest row of adj(K - lambda I) (symmetric: rows are columns)
    const Minors m4 = minors4(a);
    double q[4] = {0.0, 0.0, 0.0, 0.0}, q_n2 = 0.0;
    {
        const double r0[4] = {a[1][1] * m4.c5 - a[1][2] * m4.c4 + a[1][3] * m4.c3,
                              -a[0][1] * m4.c5 + a[0][2] * m4.c4 - a[0][3] * m4.c3,
                              a[3][1] * m4.s5 - a[3][2] * m4.s4 + a[3][3] * m4.s3,
                              -a[2][1] * m4.s5 + a[2][2] * m4.s4 - a[2][3] * m4.s3};
        keep_longest(r0, q, q_n2);
        const double r1[4] = {-a[1][0] * m4.c5 + a[1][2] * m4.c2 - a[1][3] * m4.c1,
                              a[0][0] * m4.c5 - a[0][2] * m4.c2 + a[0][3] * m4.c1,
                              -a[3][0] * m4.s5 + a[3][2] * m4.s2 - a[3][3] * m4.s1,
                              a[2][0] * m4.s5 - a[2][2] * m4.s2 + a[2][3] * m4.s1};
        keep_longest(r1, q, q_n2);
        const double r2[4] = {a[1][0] * m4.c4 - a[1][1] * m4.c2 + a[1][3] * m4.c0,
                              -a[0][0] * m4.c4 + a[0][1] * m4.c2 - a[0][3] * m4.c0,
                              a[3][0] * m4.s4 - a[3][1] * m4.s2 + a[3][3] * m4.s0,
                              -a[2][0] * m4.s4 + a[2][1] * m4.s2 - a[2][3] * m4.s0};
        keep_longest(r2, q, q_n2);
        const double r3[4] = {-a[1][0] * m4.c3 + a[1][1] * m4.c1 - a[1][2] * m4.c0,
                              a[0][0] * m4.c3 - a[0][1] * m4.c1 + a[0][2] * m4.c0,
                              -a[3][0] * m4.s3 + a[3][1] * m4.s1 - a[3][2] * m4.s0,
                              a[2][0] * m4.s3 - a[2][1] * m4.s1 + a[2][2] * m4.s0};
        keep_longest(r3, q, q_n2);
    }
    // a simple top eigenvalue leaves a row of size ~ gap^3; below 1e-12 of
    // the scale cubed the row is rounding noise: the eigenvalue repeats
    const double floor3 = 1e-12 * lam0 * lam0 * lam0;
    if (!(q_n2 > floor3 * floor3)) {
        null_vector(a, q);
        q_n2 = dot4(q, q);
    }
    const double inv = 1.0 / sqrt(q_n2);
    const double qw = q[0] * inv, qx = q[1] * inv, qy = q[2] * inv, qz = q[3] * inv;
    R[0][0] = 1.0 - 2.0 * (qy * qy + qz * qz);
    R[0][1] = 2.0 * (qx * qy - qz * qw);
    R[0][2] = 2.0 * (qx * qz + qy * qw);
    R[1][0] = 2.0 * (qx * qy + qz * qw);
    R[1][1] = 1.0 - 2.0 * (qx * qx + qz * qz);
    R[1][2] = 2.0 * (qy * qz - qx * qw);
    R[2][0] = 2.0 * (qx * qz - qy * qw);
    R[2][1] = 2.0 * (qy * qz + qx * qw);
    R[2][2] = 1.0 - 2.0 * (qx * qx + qy * qy);
    for (int i = 0; i < 3; ++i)
        t[i] = mu_d[i] - (R[i][0] * mu_s[0] + R[i][1] * mu_s[1] + R[i][2] * mu_s[2]);
}

// ---- end of the factorisation ---------------------------------------------

// Starts copying count floats from global to shared memory (dst 16-byte
// aligned) with cp.async, every copy in flight at once: 16 bytes a copy
// when src is 16-byte aligned, then the ragged tail 4 bytes a copy.  The
// caller commits the group and waits for it.
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

__device__ __forceinline__ void commit_stage() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `Pending` of this thread's committed groups are in
// flight, then for every thread of the block.
template <int Pending>
__device__ __forceinline__ void wait_stage() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
    __syncthreads();
}

// m += the moments of one weighted pair.
__device__ __forceinline__ void accumulate(double (&m)[NMOM], float w,
                                           const float* s, const float* d) {
    const double wd = w;
    const double ws[3] = {wd * s[0], wd * s[1], wd * s[2]};
    const double dd[3] = {d[0], d[1], d[2]};
    m[0] += wd;
    for (int r = 0; r < 3; ++r) {
        m[1 + r] += ws[r];
        m[4 + r] = fma(wd, dd[r], m[4 + r]);
    }
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) m[7 + 3 * i + j] = fma(ws[i], dd[j], m[7 + 3 * i + j]);
}

// One halving step of the warp's reduce-scatter: lanes with the `2 C` bit
// set keep the upper C of their 2 C values, the others the lower C, each
// adding its partner's copy of the half it keeps.
template <int C>
__device__ __forceinline__ void fold(double (&v)[NMOM], int lane) {
    const bool upper = (lane & (2 * C)) != 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        const double send = upper ? v[j] : v[j + C];
        const double keep = upper ? v[j + C] : v[j];
        v[j] = keep + __shfl_xor_sync(FULL, send, 2 * C);
    }
}

// Adds each thread's 16 moments over the block into part[warp][k]: the
// warp's reduce-scatter leaves lane l with moment k = bitrev4(l >> 1) in
// v[0], the even lane of each pair stores it; then the caller's thread 0
// adds the warps' partials in warp order (`totals`).  Ends in a barrier.
__device__ __forceinline__ void reduce_moments(double (&v)[NMOM], double* part) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    fold<8>(v, lane);
    fold<4>(v, lane);
    fold<2>(v, lane);
    fold<1>(v, lane);
    v[0] += __shfl_xor_sync(FULL, v[0], 1);
    const int k = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 +
                  ((lane >> 1) & 1);
    if ((lane & 1) == 0) part[warp * NMOM + k] = v[0];
    __syncthreads();
}

__device__ __forceinline__ void totals(const double* part, double (&m)[NMOM]) {
#pragma unroll
    for (int k = 0; k < NMOM; ++k) {
        double s = part[k];
        for (int w = 1; w < WARPS; ++w) s += part[w * NMOM + k];
        m[k] = s;
    }
}

__device__ __forceinline__ void write_pose(float* o, const double (&R)[3][3],
                                           const double (&t)[3]) {
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) o[4 * i + j] = (float)R[i][j];
        o[4 * i + 3] = (float)t[i];
    }
    o[12] = 0.0f;
    o[13] = 0.0f;
    o[14] = 0.0f;
    o[15] = 1.0f;
}

// kStaged: the problem is first copied into shared memory (N <= MAX_N);
// otherwise every pass reads it from global memory (the streamed path).
template <bool kStaged>
__global__ void __launch_bounds__(THREADS)
rigid_fit_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 const float* __restrict__ weights, float* __restrict__ out, int n) {
    extern __shared__ __align__(16) float sm[];
    __shared__ double part[WARPS * NMOM];
    const long long b = blockIdx.x;
    const int n3 = 3 * n;
    const float* ss = src + b * n3;
    const float* sd = dst + b * n3;
    const float* sw = weights ? weights + b * n : nullptr;
    if (kStaged) {
        const int off_d = round4(n3);
        stage(sm, ss, n3);
        stage(sm + off_d, sd, n3);
        if (sw) stage(sm + 2 * off_d, sw, n);
        commit_stage();
        wait_stage<0>();
        ss = sm;
        sd = sm + off_d;
        if (sw) sw = sm + 2 * off_d;
    }

    double v[NMOM];
    for (int k = 0; k < NMOM; ++k) v[k] = 0.0;
    for (int i = threadIdx.x; i < n; i += THREADS)
        accumulate(v, sw ? sw[i] : 1.0f, ss + 3 * i, sd + 3 * i);
    reduce_moments(v, part);
    if (threadIdx.x != 0) return;
    double m[NMOM], R[3][3], t[3];
    totals(part, m);
    solve(m, R, t);
    write_pose(out + b * 16, R, t);
}

template <bool kStaged>
__global__ void __launch_bounds__(THREADS)
rigid_refit_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                   const float* __restrict__ w1, const float* __restrict__ keep,
                   const float* __restrict__ gate, float gate_value,
                   float* __restrict__ out, float* __restrict__ w2,
                   int* __restrict__ count, int n) {
    extern __shared__ __align__(16) float sm[];
    __shared__ double part[WARPS * NMOM];
    __shared__ int cpart[WARPS];
    __shared__ float T1[12];
    const long long b = blockIdx.x;
    const int n3 = 3 * n;
    const float* ss = src + b * n3;
    const float* sd = dst + b * n3;
    const float* sw = w1 + b * n;
    const float* sk = keep + b * n;
    const float* sg = gate ? gate + b * n : nullptr;
    if (kStaged) {
        const int off_d = round4(n3);
        const int off_w = 2 * off_d, off_k = off_w + round4(n);
        // the points and w1 first; keep and the gate arrive during the
        // first fit
        stage(sm, ss, n3);
        stage(sm + off_d, sd, n3);
        stage(sm + off_w, sw, n);
        commit_stage();
        stage(sm + off_k, sk, n);
        if (sg) stage(sm + off_k + round4(n), sg, n);
        commit_stage();
        wait_stage<1>();
        ss = sm;
        sd = sm + off_d;
        sw = sm + off_w;
        sk = sm + off_k;
        if (sg) sg = sm + off_k + round4(n);
    }

    // the first fit, rounded to f32 as the two-call route hands it on
    double v[NMOM];
    for (int k = 0; k < NMOM; ++k) v[k] = 0.0;
    for (int i = threadIdx.x; i < n; i += THREADS)
        accumulate(v, sw[i], ss + 3 * i, sd + 3 * i);
    reduce_moments(v, part);
    if (threadIdx.x == 0) {
        double m[NMOM], R[3][3], t[3];
        totals(part, m);
        solve(m, R, t);
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) T1[4 * i + j] = (float)R[i][j];
            T1[4 * i + 3] = (float)t[i];
        }
    }
    if (kStaged)
        wait_stage<0>();
    else
        __syncthreads();

    // residuals at T1 in f32, the gate, the second fit's moments (the
    // streamed path reads the points a second time here)
    float T[12];
    for (int k = 0; k < 12; ++k) T[k] = T1[k];
    float* wo = w2 + b * n;
    for (int k = 0; k < NMOM; ++k) v[k] = 0.0;
    int c = 0;
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const float* s = ss + 3 * i;
        const float* d = sd + 3 * i;
        float e[3];
        for (int r = 0; r < 3; ++r)
            e[r] = (s[0] * T[4 * r] + s[1] * T[4 * r + 1] + s[2] * T[4 * r + 2] +
                    T[4 * r + 3]) - d[r];
        const float err = sqrtf(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
        const float g = sg ? sg[i] : gate_value;
        const float wk = sk[i] * (err < g ? 1.0f : 0.0f);
        wo[i] = wk;
        c += wk != 0.0f;
        accumulate(v, wk, s, d);
    }
    c = __reduce_add_sync(FULL, c);
    if ((threadIdx.x & 31) == 0) cpart[threadIdx.x >> 5] = c;
    reduce_moments(v, part);
    if (threadIdx.x != 0) return;
    double m[NMOM], R[3][3], t[3];
    totals(part, m);
    solve(m, R, t);
    write_pose(out + b * 16, R, t);
    int total = cpart[0];
    for (int w = 1; w < WARPS; ++w) total += cpart[w];
    count[b] = total;
}

// 3 N floats a problem must index within an int
bool valid(int batch, int n) {
    return batch >= 0 && n >= 0 && n <= (0x7fffffff / 3);
}

}  // namespace

// Lets the staged kernels take the dynamic shared memory of MAX_N points
// (above the default 48 KB); the streamed ones take none.  Called once, when
// the library is loaded, outside any stream capture.  Returns the cudaError.
extern "C" int rigid_fit_setup() {
    const int bytes = smem_bytes(MAX_N, 3);
    cudaError_t err = cudaFuncSetAttribute(
        rigid_fit_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(rigid_refit_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return static_cast<int>(err);
}

// weights may be null (every weight 1).  Any N: N <= MAX_N takes the staged
// path, a larger N the streamed one.  Returns the launch's cudaError.
extern "C" int rigid_fit_launch(const float* src, const float* dst,
                                const float* weights, float* out, int batch,
                                int n, void* stream) {
    if (!valid(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= MAX_N)
        rigid_fit_kernel<true><<<batch, THREADS, smem_bytes(n, weights ? 1 : 0), s>>>(
            src, dst, weights, out, n);
    else
        rigid_fit_kernel<false><<<batch, THREADS, 0, s>>>(src, dst, weights, out, n);
    return static_cast<int>(cudaGetLastError());
}

// gate may be null: every point's gate is gate_value.  out (B, 4, 4) is the
// second fit, w2 (B, N) its weights, count (B,) int32 their nonzeros.  Any
// N, as rigid_fit_launch.
extern "C" int rigid_refit_launch(const float* src, const float* dst,
                                  const float* w1, const float* keep,
                                  const float* gate, float gate_value, float* out,
                                  float* w2, int* count, int batch, int n,
                                  void* stream) {
    if (!valid(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= MAX_N)
        rigid_refit_kernel<true><<<batch, THREADS, smem_bytes(n, gate ? 3 : 2), s>>>(
            src, dst, w1, keep, gate, gate_value, out, w2, count, n);
    else
        rigid_refit_kernel<false><<<batch, THREADS, 0, s>>>(
            src, dst, w1, keep, gate, gate_value, out, w2, count, n);
    return static_cast<int>(cudaGetLastError());
}
