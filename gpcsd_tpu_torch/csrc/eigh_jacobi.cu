// Batched symmetric eigensolver, float64, for sm_90a: two-sided block
// Jacobi, one thread-block cluster per matrix, nothing read back to the host.
//
//     B_c = V_c diag(w_c) V_c^T  for every row c of a (C, n, n) batch   (eigh_jacobi_f64)
//
// It replaces no Pallas kernel.  The JAX package solves the temporal
// eigenproblem on the TPU with a block Jacobi built from XLA ops
// (gpcsd_tpu/ops/jacobi.py:191 _eigh_block_jacobi); the port called
// cuSOLVER's syevd through torch.linalg.eigh instead, one row after another,
// each solve some 70 launches and a read of its error flag by the host.  At
// n = 600 that took ~5.7 ms a row, most of it syevd's tridiagonal reduction,
// a chain of ~n dependent panel steps bound by latency on a fraction of the
// card (PERF.md: 0.83 of 1.01 s of device time in the 10-row MAP cell).
//
// What bounds it.  A sweep of two-sided block Jacobi applies, in every
// round, each pair's 2b x 2b rotation to its block rows and columns of B
// and to its block columns of V: ~12 n^3 FLOPs a sweep (~9 n^3 with B's
// symmetry), 2.2 GFLOP at n = 608, or 33 us of the card's 67 TFLOP/s FP64
// tensor-core peak; a solve takes five sweeps on the cells' covariances.
// The rounds of a sweep are sequential, and so are the 31 steps of a
// round's pair problems: one matrix is bound by latency, ~2n dependent
// rotation steps a sweep whatever the block size b.  On an H100 at 700 W a
// round of the n = 600 matrix takes ~110k cycles (clock64 in the kernel):
// step a ~44k (~1,000 a step: the rotations ~300, the updates of S and Q in
// shared memory ~700), waiting at b for the CTAs with two pairs ~18k, step c
// ~34k, waiting at d ~15k; 185 rounds a solve, 10-11 ms (PERF.md).  The
// design spends the card on many matrices at once instead of one:
//
// 1. One cluster of K CTAs per matrix (grid K x C, cluster K x 1), K chosen
//    by the wrapper from the row count and n so that the C clusters run in
//    one wave where they can; the CTAs of a cluster meet at the cluster's
//    hardware barrier, twice a round, and never wait for another matrix.
//    The arithmetic does not depend on K: any K gives the same bits.
// 2. B (npad x npad) and V live in device memory, 2.9 MB each at npad =
//    608, and stay in the 50 MB L2; the kernel reads them with ld.global.cg
//    (L2, not the SM's L1, which another CTA's writes would leave stale).
// 3. A round (the circle schedule over nb = npad/16 blocks of b = 16 rows,
//    nb/2 disjoint pairs, nb - 1 rounds a sweep):
//    a. each pair's 32 x 32 diagonal tile gets one sweep of cyclic scalar
//       Jacobi in shared memory (16 rotations a step, 31 steps; none where
//       no off-diagonal entry exceeds the threshold), accumulating its
//       32 x 32 rotation Q from I (near-identity, "inner" rotations, so
//       block Jacobi converges); the tile goes back to B, Q to a scratch.
//       A step is one barrier: lane l computes the rotation of pair l % 16
//       from the step's input tile and passes it by shuffles, and the
//       rotated tile goes to a second buffer.  A CTA with two or more pairs
//       solves two at once, on half its threads each, behind named
//       barriers.  One inner sweep takes as many outer sweeps as solving
//       the tile to the threshold (the plain version, n = 96: 5 on a
//       covariance, 8 on a random matrix, either way) with fewer rotations,
//       so V stays closer to orthogonal (largest |V^T V - I| 1.9e-14
//       against 2.7e-14, 4.0e-14 against 1.4e-13);
//    b. cluster barrier;
//    c. every off-diagonal pair tile B[P, R] <- Q_P^T B[P, R] Q_R (written
//       to both triangles: B stays exactly symmetric) and every 32-row tile
//       of V's pair columns V[:, P] <- V[:, P] Q_P, each a warp's job on the
//       FP64 tensor cores (mma.sync m16n8k8 f64, as quadform.cu), fragments
//       loaded straight from L2; tiles whose two rotations are both exactly
//       I are skipped;
//    d. cluster barrier.
//    Measured at (4, 600), slower: a warp a pair problem (16.4 ms, against
//    13.5 for a CTA a pair, both with IEEE division and square root in the
//    rotations, and 10.4 now); 512 threads a CTA, step a's S and Q updates on threads
//    of their own, 128 registers a thread (11.6); the round's rotations
//    staged in shared memory for step c (its bank conflicts cost more than
//    the L2 reads saved).
// 4. A sweep ends with the off-diagonal norm, summed in a fixed order from
//    one partial per CTA, so every CTA of the cluster takes the same
//    decision and two calls give the same bits.  The stopping rule is the
//    JAX solver's (jacobi.py:86, :164-171): off(B) <= eps * ||A||_F, or its
//    stall exit (one sweep that removed less than 10% near the tolerance,
//    or two anywhere), or max_sweeps.  A matrix that stops at max_sweeps
//    gets NaN eigenvalues and adds to the unconverged count.
// 5. The eigenvalues (B's diagonal) are ranked on the device, ties by
//    index, and the columns of V scattered to their ranks: ascending, as
//    torch.linalg.eigh gives them.  The padded eigenpairs rank last and are
//    dropped.
// 6. Sweeps and unconverged matrices are added to a device counter
//    (g_stats) that the host reads only when it asks (eigh_jacobi_f64_stats).
//
// The wrapper (gpcsd_tpu_torch/ops/cuda/eigh.py) forms B = P^T A P in the
// DCT-II basis P (a fixed orthogonal congruence that leaves a stationary
// covariance on a uniform grid nearly diagonal, so fewer sweeps) and pads it
// to npad with decoupled diagonal entries above the Gershgorin bound; the
// padding stays exactly decoupled (its rotations are exactly I).  It forms
// V = P W after the kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BS = 16;                 // rows of a block of the block grid
constexpr int TS = 2 * BS;             // rows of a pair problem
constexpr int LD = TS + 1;             // shared-memory row stride of a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int INNER_PAIRS = TS / 2;    // rotations of an inner step
constexpr int INNER_STEPS = TS - 1;    // steps of an inner sweep
constexpr int MAX_CLUSTER = 16;        // CTAs a matrix, at most (non-portable above 8)
constexpr double EPS = 2.220446049250313e-16;
constexpr int PAIR_SMEM = 3 * TS * LD;  // doubles of a pair problem's two S and its Q
constexpr size_t SMEM_BYTES = (size_t)WARPS * TS * LD * sizeof(double);  // step c's Z a warp

static_assert(2 * PAIR_SMEM <= WARPS * TS * LD, "two pair problems fit in step c's staging");

__device__ unsigned long long g_stats[2];  // sweeps, unconverged matrices

int g_max_cluster = 0;

struct Params {
    double* b;          // (C, npad, npad): the padded congruence in, scratch after
    double* w;          // (C, npad, npad): the accumulated rotation W
    double* q;          // (C, m, TS, TS): the round's pair rotations
    int* rot;           // (C, m): whether a pair's rotation is other than I
    double* part;       // (C, 2, K): off-norm partials, two alternating sets
    const double* tol;  // (C,): eps * ||A_c||_F
    double* w_out;      // (C, n)
    double* v_out;      // (C, n, n): W's columns in ascending order (rows < n)
    int n, npad, max_sweeps;
};

// D = A B + D on one m16 x n8 x k8 tile, the fragment layouts of quadform.cu:
// a[v] = A[g + 8*(v%2)][t + 4*(v/2)], b[v] = B[t + 4*v][g],
// c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}, g = lane/4, t = lane%4.
__device__ __forceinline__ void dmma_16x8x8(double (&c)[4], const double (&a)[4],
                                            const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The circle schedule over `players` (even) indices: the k-th pair of round r.
__device__ __forceinline__ void round_pair(int players, int r, int k, int& i, int& j) {
    const int L = players - 1;
    if (k == 0) {
        i = r;
        j = L;
    } else {
        i = (r + k) % L;
        j = (r - k + L) % L;
    }
}

// Index in B of row i of the pair tile of blocks (I, J).
__device__ __forceinline__ int pair_index(int i, int I, int J) {
    return i < BS ? I * BS + i : J * BS + (i - BS);
}

__device__ __forceinline__ bool exceeds(double apq, double app, double aqq, double thr) {
    return fabs(apq) > fmax(thr, EPS * (fabs(app) + fabs(aqq)));
}

// Every CTA of the matrix's cluster waits here; writes before it, to global
// or shared memory, are seen after it (the cluster barrier's arrive releases
// and its wait acquires; cooperative_groups' cluster sync without the header,
// which costs the build seconds).
__device__ __forceinline__ void row_sync() {
    __threadfence();
    asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// Sum over the CTA in a fixed order; every thread gets it.
__device__ double block_sum(double v, double* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    double s = 0.0;
    for (int i = 0; i < WARPS; ++i) s += red[i];
    __syncthreads();
    return s;
}

// 1/x and 1/sqrt(x) from the special-function unit's approximations and two
// Newton steps each (to about an ulp; the rotation needs c^2 + s^2 = 1 to
// rounding, not correctly rounded c and s): a fraction of the latency of
// IEEE division and square root, which sets the pace of an inner step.
__device__ __forceinline__ double rcp_nr(double x) {
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
    r = fma(r, fma(-x, r, 1.0), r);
    return fma(r, fma(-x, r, 1.0), r);
}

__device__ __forceinline__ double rsqrt_nr(double x) {
    double r;
    asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
    r = r * fma(-0.5 * x * r, r, 1.5);
    return r * fma(-0.5 * x * r, r, 1.5);
}

// The rotation [c s; -s c] that zeroes apq of [app apq; apq aqq] (Golub &
// Van Loan's sym.schur2: t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau =
// (aqq - app) / 2apq), with d = aqq - app, e = 2apq, h = sqrt(d^2 + e^2),
// u = |d| + h written as t = sign |e| / u, c = u / sqrt(2hu), s = sign |e| /
// sqrt(2hu) (1 + t^2 = 2h / u): two dependent square roots; or c = 1, s = t
// = 0 where apq does not exceed the threshold.
__device__ __forceinline__ void rotation(double app, double aqq, double apq, double thr,
                                         double& c, double& s, double& t) {
    c = 1.0;
    s = t = 0.0;
    if (exceeds(apq, app, aqq, thr)) {
        const double d = aqq - app, e = 2.0 * apq;
        const double es = (d == 0.0 || (d > 0.0) == (e > 0.0)) ? fabs(e) : -fabs(e);
        const double h2 = d * d + e * e;
        const double u = fabs(d) + h2 * rsqrt_nr(h2);
        const double hu = 2.0 * (u - fabs(d)) * u;
        const double r = rsqrt_nr(hu);
        c = u * r;
        s = es * r;
        t = es * rcp_nr(u);
    }
}

// A barrier of the `count` threads of group `id` (named barrier 1 + id).
__device__ __forceinline__ void group_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + id), "r"(count) : "memory");
}

// Step a, one group of `size` threads (gt its thread): a sweep of cyclic
// Jacobi on the pair tile of blocks (I, J) of B in shared memory, none where
// no off-diagonal entry exceeds the threshold; from S0 to S1 and back, one
// step a barrier.  Q accumulates the rotation from I, transposed (a thread's
// rows of a column pair are then neighbours in shared memory).  The tile goes
// back to B, Q to qg, whether Q is other than I to *rot.  With `last`, adds
// the tile's off-diagonal squares to part.
__device__ void solve_pair(const Params& p, double* B, double* qg, int* rot, int I, int J,
                           double thr, bool last, double& part, int group, int gt, int size,
                           double* S0, double* S1, double* Q, int* flag) {
    const size_t npad = p.npad;
    for (int e = gt; e < TS * TS; e += size) {
        const int i = e / TS, j = e % TS;
        S0[i * LD + j] = __ldcg(B + pair_index(i, I, J) * npad + pair_index(j, I, J));
        Q[i * LD + j] = i == j ? 1.0 : 0.0;
    }
    if (gt == 0) *flag = 0;
    group_sync(group, size);
    double* S = S0;
    bool ex = false;
    for (int e = gt; e < TS * TS; e += size) {
        const int i = e / TS, j = e % TS;
        if (i < j && exceeds(S[i * LD + j], S[i * LD + i], S[j * LD + j], thr)) ex = true;
    }
    if (ex) *flag = 1;
    group_sync(group, size);
    const bool rotated = *flag != 0;  // the same in every thread of the group
    if (rotated) {
        for (int step = 0; step < INNER_STEPS; ++step) {
            double* out = S == S0 ? S1 : S0;
            // lane l holds the rotation of pair l % 16, computed from the
            // step's input tile: the thread items (x, y) below have y = l %
            // 16, and take pair x's from lane x: no barrier between the
            // rotations and their use
            const int lane = threadIdx.x & 31;
            int pl, ql;
            round_pair(TS, step, lane % INNER_PAIRS, pl, ql);
            double cl, sl, tl;
            rotation(S[pl * LD + pl], S[ql * LD + ql], S[pl * LD + ql], thr, cl, sl, tl);
            // thread item (x, y): the 2x2 block of pairs x <= y and its
            // transpose, and Q's columns of pair x in rows 2y, 2y + 1
            for (int e = gt; e < INNER_PAIRS * INNER_PAIRS; e += size) {
                const int x = e / INNER_PAIRS, y = e % INNER_PAIRS;
                const double cx = __shfl_sync(0xffffffffu, cl, x);
                const double sx = __shfl_sync(0xffffffffu, sl, x);
                const double tx = __shfl_sync(0xffffffffu, tl, x);
                const double cy = cl, sy = sl;
                int px, qx, py, qy;
                round_pair(TS, step, x, px, qx);
                round_pair(TS, step, y, py, qy);
                if (x == y) {
                    const double app = S[px * LD + px], aqq = S[qx * LD + qx];
                    const double apq = S[px * LD + qx];
                    const bool r = tx != 0.0;
                    out[px * LD + px] = r ? app - tx * apq : app;
                    out[qx * LD + qx] = r ? aqq + tx * apq : aqq;
                    out[px * LD + qx] = r ? 0.0 : apq;
                    out[qx * LD + px] = r ? 0.0 : apq;
                } else if (x < y) {
                    const double x00 = S[px * LD + py], x01 = S[px * LD + qy];
                    const double x10 = S[qx * LD + py], x11 = S[qx * LD + qy];
                    const double y00 = cx * x00 - sx * x10, y01 = cx * x01 - sx * x11;
                    const double y10 = sx * x00 + cx * x10, y11 = sx * x01 + cx * x11;
                    const double z00 = cy * y00 - sy * y01, z01 = sy * y00 + cy * y01;
                    const double z10 = cy * y10 - sy * y11, z11 = sy * y10 + cy * y11;
                    out[px * LD + py] = z00;
                    out[py * LD + px] = z00;
                    out[px * LD + qy] = z01;
                    out[qy * LD + px] = z01;
                    out[qx * LD + py] = z10;
                    out[py * LD + qx] = z10;
                    out[qx * LD + qy] = z11;
                    out[qy * LD + qx] = z11;
                }
                if (sx != 0.0) {  // Q is kept transposed: its column px is row px here
                    for (int row = 2 * y; row < 2 * y + 2; ++row) {
                        const double vp = Q[px * LD + row], vq = Q[qx * LD + row];
                        Q[px * LD + row] = cx * vp - sx * vq;
                        Q[qx * LD + row] = sx * vp + cx * vq;
                    }
                }
            }
            S = out;
            group_sync(group, size);
        }
    }
    for (int e = gt; e < TS * TS; e += size) {
        const int i = e / TS, j = e % TS;
        const double v = S[i * LD + j];
        if (rotated) __stcg(B + pair_index(i, I, J) * npad + pair_index(j, I, J), v);
        __stcg(qg + e, Q[j * LD + i]);
        if (last && i != j) part += v * v;
    }
    if (gt == 0) __stcg(rot, (int)rotated);
    group_sync(group, size);  // the group's next pair reuses S0, S1 and Q
}

// Step c for the off-diagonal pair tile (P, R), P = pair k1, R = pair k2:
// B[P, R] <- Q_P^T B[P, R] Q_R, and its transpose into B[R, P].  One warp.
__device__ void rotate_b_tile(const Params& p, double* B, const double* q1, const double* q2,
                              int I1, int J1, int I2, int J2, bool skip, bool last,
                              double& part, double* Z) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const size_t npad = p.npad;
    if (skip) {  // both rotations are I: the tile stays, its squares may count
        if (last) {
#pragma unroll
            for (int e = 0; e < TS; ++e) {
                const double x = __ldcg(B + pair_index(e, I1, J1) * npad + pair_index(lane, I2, J2));
                part += 2.0 * x * x;
            }
        }
        return;
    }
    double acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.0;
    // Z = X Q_R, X = B[P, R]
#pragma unroll
    for (int ks = 0; ks < TS / 8; ++ks) {
        double a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                const int r = 16 * mi + g + 8 * (v & 1), c = 8 * ks + t4 + 4 * (v >> 1);
                a[mi][v] = __ldcg(B + pair_index(r, I1, J1) * npad + pair_index(c, I2, J2));
            }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 2; ++v) b[ni][v] = __ldcg(q2 + (8 * ks + t4 + 4 * v) * TS + 8 * ni + g);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) dmma_16x8x8(acc[mi][ni], a[mi], b[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                Z[(16 * mi + g + 8 * (v >> 1)) * LD + 8 * ni + 2 * t4 + (v & 1)] = acc[mi][ni][v];
                acc[mi][ni][v] = 0.0;
            }
    __syncwarp();
    // Y = Q_P^T Z
#pragma unroll
    for (int ks = 0; ks < TS / 8; ++ks) {
        double a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int v = 0; v < 4; ++v)
                a[mi][v] = __ldcg(q1 + (8 * ks + t4 + 4 * (v >> 1)) * TS + 16 * mi + g + 8 * (v & 1));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 2; ++v) b[ni][v] = Z[(8 * ks + t4 + 4 * v) * LD + 8 * ni + g];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) dmma_16x8x8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncwarp();  // every lane's reads of X and Z are done
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                const int r = pair_index(16 * mi + g + 8 * (v >> 1), I1, J1);
                const int c = pair_index(8 * ni + 2 * t4 + (v & 1), I2, J2);
                const double y = acc[mi][ni][v];
                __stcg(B + r * npad + c, y);
                __stcg(B + c * npad + r, y);
                if (last) part += 2.0 * y * y;
            }
}

// Step c for rows row0 .. row0 + 31 of W's pair columns (I, J): W <- W Q.
__device__ void rotate_w_tile(const Params& p, double* W, const double* qk, int row0, int I,
                              int J) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const size_t npad = p.npad;
    double acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.0;
#pragma unroll
    for (int ks = 0; ks < TS / 8; ++ks) {
        double a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                const int r = row0 + 16 * mi + g + 8 * (v & 1), c = 8 * ks + t4 + 4 * (v >> 1);
                a[mi][v] = __ldcg(W + r * npad + pair_index(c, I, J));
            }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 2; ++v) b[ni][v] = __ldcg(qk + (8 * ks + t4 + 4 * v) * TS + 8 * ni + g);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) dmma_16x8x8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncwarp();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                const int r = row0 + 16 * mi + g + 8 * (v >> 1);
                const int c = pair_index(8 * ni + 2 * t4 + (v & 1), I, J);
                __stcg(W + r * npad + c, acc[mi][ni][v]);
            }
}

__global__ void __launch_bounds__(THREADS, 1) eigh_jacobi_kernel(Params p) {
    extern __shared__ __align__(16) double smem[];
    __shared__ double red[WARPS];
    __shared__ int flag[2];
    const int tid = threadIdx.x, warp = tid >> 5;
    const int rank = blockIdx.x, K = gridDim.x, row = blockIdx.y;
    const int npad = p.npad, nb = npad / BS, m = nb / 2;
    const size_t nn = (size_t)npad * npad;
    double* B = p.b + row * nn;
    double* W = p.w + row * nn;
    double* q = p.q + (size_t)row * m * TS * TS;
    int* rot = p.rot + (size_t)row * m;
    double* part = p.part + (size_t)row * 2 * K;
    const double tol = __ldg(p.tol + row);
    const double thr = tol / npad;

    // W = I, and the off-diagonal norm of the input
    double acc = 0.0;
    for (size_t e = (size_t)rank * THREADS + tid; e < nn; e += (size_t)K * THREADS) {
        const size_t i = e / npad, j = e % npad;
        __stcg(W + e, i == j ? 1.0 : 0.0);
        if (i != j) {
            const double x = __ldcg(B + e);
            acc += x * x;
        }
    }
    acc = block_sum(acc, red);
    int set = 0;
    if (tid == 0) __stcg(part + set * K + rank, acc);
    row_sync();
    double off = 0.0;
    for (int k = 0; k < K; ++k) off += __ldcg(part + set * K + k);
    off = sqrt(off);

    int sweeps = 0, nstall = 0;
    bool stalled = false;
    while (off > tol && !stalled && sweeps < p.max_sweeps) {
        const double before = off;
        double mine = 0.0;
        for (int r = 0; r < nb - 1; ++r) {
            const bool last = r == nb - 2;
            // the CTA's pairs k = rank, rank + K, ...: two at once where it has
            // two or more, each on half the threads
            {
                const int mine_pairs = rank < m ? (m - rank + K - 1) / K : 0;
                const int groups = mine_pairs >= 2 ? 2 : 1, size = THREADS / groups;
                const int g = tid / size, gt = tid % size;
                for (int j = g; j < mine_pairs; j += groups) {
                    const int k = rank + j * K;
                    int I, J;
                    round_pair(nb, r, k, I, J);
                    double* tiles = smem + g * PAIR_SMEM;
                    solve_pair(p, B, q + (size_t)k * TS * TS, rot + k, I, J, thr, last, mine, g,
                               gt, size, tiles, tiles + TS * LD, tiles + 2 * TS * LD, flag + g);
                }
            }
            row_sync();
            const int nbt = m * (m - 1) / 2, total = nbt + m * m;
            for (int item = rank * WARPS + warp; item < total; item += K * WARPS) {
                if (item < nbt) {
                    int k1 = 0, rem = item;
                    while (rem >= m - 1 - k1) {
                        rem -= m - 1 - k1;
                        ++k1;
                    }
                    const int k2 = k1 + 1 + rem;
                    int I1, J1, I2, J2;
                    round_pair(nb, r, k1, I1, J1);
                    round_pair(nb, r, k2, I2, J2);
                    const bool skip = __ldcg(rot + k1) == 0 && __ldcg(rot + k2) == 0;
                    rotate_b_tile(p, B, q + (size_t)k1 * TS * TS, q + (size_t)k2 * TS * TS, I1, J1,
                                  I2, J2, skip, last, mine, smem + warp * TS * LD);
                } else {
                    const int k = (item - nbt) % m, tile = (item - nbt) / m;
                    if (__ldcg(rot + k) == 0) continue;
                    int I, J;
                    round_pair(nb, r, k, I, J);
                    rotate_w_tile(p, W, q + (size_t)k * TS * TS, tile * TS, I, J);
                }
            }
            if (last) {
                mine = block_sum(mine, red);
                if (tid == 0) __stcg(part + (set ^ 1) * K + rank, mine);
            }
            row_sync();
        }
        set ^= 1;
        off = 0.0;
        for (int k = 0; k < K; ++k) off += __ldcg(part + set * K + k);
        off = sqrt(off);
        ++sweeps;
        nstall = off >= 0.9 * before ? nstall + 1 : 0;
        stalled = (nstall >= 1 && off < 10.0 * tol) || nstall >= 2;
    }
    const bool unconverged = off > tol && !stalled;

    // rank the eigenvalues (ties by index) and scatter W's columns to their ranks
    double* diag = smem;
    const bool in_smem = (size_t)npad * sizeof(double) <= SMEM_BYTES;
    if (in_smem)
        for (int i = tid; i < npad; i += THREADS) diag[i] = __ldcg(B + (size_t)i * npad + i);
    __syncthreads();
    const int n = p.n;
    for (int i = rank * THREADS + tid; i < npad; i += K * THREADS) {
        const double di = in_smem ? diag[i] : __ldcg(B + (size_t)i * npad + i);
        int rk = 0;
        for (int j = 0; j < npad; ++j) {
            const double dj = in_smem ? diag[j] : __ldcg(B + (size_t)j * npad + j);
            rk += (dj < di) || (dj == di && j < i);
        }
        if (rk < n) {
            p.w_out[(size_t)row * n + rk] = unconverged ? __longlong_as_double(0x7ff8000000000000LL) : di;
            double* v = p.v_out + (size_t)row * n * n;
            for (int r = 0; r < n; ++r) v[(size_t)r * n + rk] = __ldcg(W + (size_t)r * npad + i);
        }
    }
    if (rank == 0 && tid == 0) {
        atomicAdd(&g_stats[0], (unsigned long long)sweeps);
        atomicAdd(&g_stats[1], (unsigned long long)unconverged);
    }
}

cudaLaunchConfig_t launch_config(int cluster, int rows, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, rows, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

}  // namespace

extern "C" {

// Prepares the kernel on the current device: SMEM_BYTES of dynamic shared
// memory, clusters above 8 CTAs; finds the largest cluster the device
// takes.  Returns a cudaError_t (0 on success).
int eigh_jacobi_f64_init(void) {
    const void* fn = (const void*)eigh_jacobi_kernel;
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config(MAX_CLUSTER, 1, 0, attr);
    cfg.numAttrs = 0;
    int size = 0;
    err = cudaOccupancyMaxPotentialClusterSize(&size, eigh_jacobi_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    g_max_cluster = size < MAX_CLUSTER ? size : MAX_CLUSTER;
    return g_max_cluster > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// The largest cluster (CTAs a matrix) the device takes, after init.
int eigh_jacobi_f64_max_cluster(void) { return g_max_cluster; }

// Clusters of `cluster` CTAs that the device runs at once (one wave), or -1.
int eigh_jacobi_f64_active_clusters(int cluster) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config(cluster, 1, 0, attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, eigh_jacobi_kernel, &cfg) != cudaSuccess) return -1;
    return n;
}

// Launches the solver on `stream` for `rows` matrices; returns a cudaError_t
// (0 on success).  b: (rows, npad, npad) symmetric, padded (overwritten);
// w: (rows, npad, npad) scratch; q: (rows, npad/32, 32, 32) scratch; rot:
// (rows, npad/32) ints; part: (rows, 2, cluster) scratch; tol: (rows,);
// w_out: (rows, n) eigenvalues ascending; v_out: (rows, n, n), column j the
// j-th eigenvector (of the padded matrix, rows < n).  All row-major,
// contiguous, float64 unless said, on the current device.
int eigh_jacobi_f64(double* b, double* w, double* q, int* rot, double* part, const double* tol,
                    double* w_out, double* v_out, int rows, int n, int npad, int cluster,
                    int max_sweeps, void* stream) {
    if (rows < 1 || n < 1 || npad != (n + TS - 1) / TS * TS || cluster < 1 ||
        cluster > g_max_cluster || max_sweeps < 0 || rows > 65535)
        return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config(cluster, rows, (cudaStream_t)stream, attr);
    Params p{b, w, q, rot, part, tol, w_out, v_out, n, npad, max_sweeps};
    cudaError_t err = cudaLaunchKernelEx(&cfg, eigh_jacobi_kernel, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Waits for the device, copies the sweep and unconverged counts into
// out[0..1] and, with reset, sets them to 0.  Returns a cudaError_t.
int eigh_jacobi_f64_stats(unsigned long long* out, int reset) {
    cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyFromSymbol(out, g_stats, sizeof(g_stats));
    if (err != cudaSuccess || !reset) return (int)err;
    const unsigned long long zero[2] = {0, 0};
    return (int)cudaMemcpyToSymbol(g_stats, zero, sizeof(g_stats));
}

const char* eigh_jacobi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
