// Fused Kronecker-whitened quadratic form, float64, for sm_90a.
//
//     out = sum_b sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij            (quadform_f64)
//     out[b] = sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij               (quadform_rows_f64)
//
// Replaces the Pallas TPU kernel gpcsd_tpu/ops/pallas/quadform.py
// (_quadform_kernel, pallas_call at :66): the quadratic term of the
// Kronecker marginal likelihood.  Like it, the whitened (ntrials, nx, nt)
// array alpha never reaches device memory.  Unlike it, everything is
// float64 with float64 accumulation: at the auditory paper configuration
// the term is ~1.4e6 and the log-joint ~2.14e6, and the likelihood is held
// to 1e-8 relative, which an f32 sum of 1.44e6 squares cannot meet.
//
// What bounds it.  At nx=24, nt=600, ntrials=100 the useful work is 1.73
// GFLOP for (.)Qt plus 0.07 GFLOP for Qs^T Y_b, against 11.5 MB of Y and
// 2.9 MB of Qt (L2-resident) read: ~3.4 us of memory traffic at 3.35 TB/s,
// but ~27 us of FP64 tensor-core (DMMA) work at the H100 SXM's 67 TFLOP/s
// data-sheet peak, so the product with Qt runs on the tensor cores.  On an
// H100 at 700 W the three kernels take ~57 us (W 10, GEMM 45, sum 2): 32
// TFLOP/s of useful work, 47% of the DMMA peak.  The GEMM's DMMAs alone
// take 36 us (cuBLAS's DGEMM of the same shape and tile takes 37); of the
// rest, the TMA copies cost ~2 us and the loop around the DMMAs (a barrier
// and the fragment loads of each chunk) ~7.  The W pre-pass, 10 us for 69
// MFLOP, is bound by moving Y in and W out (PERF.md).
//
// Design.
// 1. One GEMM over stacked trials.  Rows m = b*nx + i (M = ntrials*nx),
//    columns j and depth k both over nt:
//        alpha[m, j] = sum_k W[m, k] Qt[k, j],  W[m, k] = (Qs^T Y_b)[i, k].
//    A row tile may straddle trials, so no row is padded to a tile of one
//    trial, and any nx works: there is no limit on nx.
// 2. W is formed once, by whiten_rows_kernel (CUDA cores, 2*M*nx*nt FLOPs),
//    into a scratch (M, kpad) array the caller allocates, with kpad = nt
//    rounded up to BK and the columns k >= nt zeroed; 11.5 MB at the main
//    shape, it stays in the 50 MB L2.
// 3. quadform_gemm_kernel runs the product on the FP64 tensor cores with
//    mma.sync.aligned.m16n8k8.row.col.f64, one of the f64 shapes sm_90 adds
//    (wgmma has no f64; m16n8k4 and m16n8k16 were no faster).  A block of
//    WARPS_M x WARPS_N warps owns a BM x BN alpha tile; each warp a WM x WN
//    sub-tile held in registers as (WM/16) x (WN/8) accumulators of 4
//    doubles.  Fragments come from shared memory by plain 64-bit loads
//    (ldmatrix has no 64-bit form).
// 4. The Tensor Memory Accelerator fills a ring of STAGES shared-memory
//    stages: per k-chunk one thread issues W's BM x BK box and BN/QBOX
//    BK x QBOX boxes of Qt, and the stage's mbarrier counts their bytes.
//    The tensor maps zero-fill past M and past nt in j and k, so no edge
//    needs a mask.  While chunk k is on the tensor cores, chunks k+1 ..
//    k+STAGES-1 are in flight; one __syncthreads per chunk frees a stage.
//    Tensor maps need 16-byte aligned row strides, so an odd nt's Qt is
//    first copied to a row stride of nt + 1 inside the scratch.  The boxes
//    land with TMA's 128-byte swizzle, and the 16 k of a chunk are taken in
//    an order (kperm) that puts every half-warp's fragment load on 16
//    distinct bank pairs, on W and on Qt.
// 5. The epilogue squares alpha in registers, weights it by
//    dinv[m mod nx, j], reduces with warp shuffles and writes one partial
//    per block.  A second single-block kernel sums the partials in a fixed
//    order, so two calls give the same bits; no atomics.
// 6. The per-trial output (quadform_rows_f64, for callers such as the shift
//    stage whose B rows share Qs, Qt and dinv but need one value each) runs
//    the same W pre-pass and GEMM with another epilogue, chosen by the
//    GEMM's template parameter so that the scalar instantiation is
//    unchanged: each accumulator row m is reduced along j, first over the
//    4 lanes of the m16n8k8 fragment that share it (shuffles), then over
//    the block's WARPS_N warps (shared memory), and written as one partial
//    per (row m, column tile).  Rows, not trials, are the unit, so a row
//    tile that straddles trials needs no mask.  The reduction kernel then
//    runs one block per trial over that trial's nx * tiles_n partials,
//    which are contiguous, in the scalar path's fixed order.
// Tile sizes (the constants below).  BM = BN = 64 with 2 x 2 warps of
// 32 x 32, and BK = 16 in 4 stages of 16 KB: a 32 x 32 warp tile reads 0.5 B
// of shared memory per DMMA FMA, half the SM's 128 B/clk at peak; the GEMM
// is built for 3 blocks (12 warps) per SM, at most 170 registers a thread,
// and the main shape's 380 blocks fill the 396 slots of one wave.  Measured
// on the card, no faster or slower: 2 or 3 stages, BK = 32, 2 blocks per
// SM, 64 x 32 warp tiles, 96- and 128-row blocks (fewer warps per SM, or
// fewer blocks than 3 per SM), per-stage "empty" mbarriers in place of the
// __syncthreads, a cp.async ring (GEMM 52 us) and per-row bulk copies (119
// us).  The W kernel's 24 rows x 24 staged Qs rows per thread and 128
// threads per block were the fastest of the shapes tried.
//
// History: the first port (one block per (trial, 32-row, 64-column) alpha
// tile, W recomputed in shared memory by every column tile, scalar FP64
// FMAs on the CUDA cores, synchronous staging) executed ~1.9x the useful
// FLOPs, was bound by issuing 6 shared-memory loads per 8 FMAs, and took
// 0.461 ms at the main shape against 0.077 ms for cuBLAS (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                // alpha rows (m = b*nx + i) per block
constexpr int BN = 64;                // alpha columns (j) per block
constexpr int WM = 32;                // alpha rows per warp
constexpr int WN = 32;                // alpha columns per warp
constexpr int BK = 16;                // depth (k) of one staged chunk
constexpr int STAGES = 4;             // shared-memory ring depth
constexpr int MIN_BLOCKS = 3;         // blocks per SM the GEMM is built for
constexpr int MMA_K = 8;              // depth of one DMMA (dmma_16x8x8 below)
constexpr int WARPS_M = BM / WM;
constexpr int WARPS_N = BN / WN;
constexpr int WARPS = WARPS_M * WARPS_N;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = WM / 16;           // m16 fragments per warp
constexpr int NT = WN / 8;            // n8 fragments per warp
constexpr int QBOX = 16;              // Qt columns per TMA box (128 B, the swizzle span)
constexpr int STAGE_DOUBLES = BM * BK + BK * BN;
constexpr unsigned STAGE_BYTES = STAGE_DOUBLES * sizeof(double);
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES + 1024;  // + alignment to 1 KB
constexpr int W_THREADS = 128;        // whiten_rows_kernel: one k per thread
constexpr int W_ROWS = 24;            // ... and W_ROWS rows i per thread
constexpr int W_XC = 24;              // rows x of Qs staged (and Y loads in flight) at a time
constexpr int REDUCE_THREADS = 256;

static_assert(BM % WM == 0 && BN % WN == 0, "warp tiles must divide the block tile");
static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tiles are made of m16n8 fragments");
static_assert(BK == 16 && MMA_K == 8, "the k order below is for two k8 steps a chunk");
static_assert(BN % QBOX == 0 && STAGE_BYTES % 1024 == 0, "TMA boxes and 1 KB swizzle atoms");
static_assert(STAGES >= 2, "a ring needs two stages");
// MIN_BLOCKS blocks, each with 1 KB reserved, in the SM's 228 KB (the
// per-row epilogue adds WARPS_N x BM doubles)
static_assert(MIN_BLOCKS * (SMEM_BYTES + 1024 + (WARPS + STAGES + WARPS_N * BM) * sizeof(double))
                  <= 233472,
              "MIN_BLOCKS blocks must fit in an SM's shared memory");

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}

// The one arrival of the barrier's phase, announcing `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// TMA: the box of `map` at (c0 inner, c1 outer) into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(double* smem, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3}], [%4];\n"
                 :: "r"(smem_addr(smem)), "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
                 : "memory");
}

// D = A B + D on one m16 x n8 x k8 tile.  Fragments (g = lane/4, t = lane%4):
// a[v] = A[g + 8*(v%2)][t + 4*(v/2)], b[v] = B[t + 4*v][g],
// c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}  (CuTe's
// SM90_16x8x8_F64F64F64F64_TN layouts).
__device__ __forceinline__ void dmma_16x8x8(double (&c)[4], const double (&a)[4],
                                            const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// W[b*nx + i, k] = sum_x Qs[x, i] Y[b, x, k] for k < nt, 0 for nt <= k < kpad.
// One thread per (b, k, group of W_ROWS rows): Y reads are coalesced along
// k and unrolled so that several are in flight; Qs[x-chunk, i-group] is
// staged in shared memory and read as a broadcast.
__global__ void __launch_bounds__(W_THREADS)
whiten_rows_kernel(const double* __restrict__ qs, const double* __restrict__ y,
                   double* __restrict__ w, int nx, int nt, int kpad,
                   int groups_i, int chunks_k) {
    __shared__ double qs_s[W_XC][W_ROWS];
    int bid = blockIdx.x;
    const int kc = bid % chunks_k;
    bid /= chunks_k;
    const int i0 = (bid % groups_i) * W_ROWS;
    const int b = bid / groups_i;
    const int k = kc * W_THREADS + threadIdx.x;
    const double* yk = y + (size_t)b * nx * nt + k;
    double acc[W_ROWS];
#pragma unroll
    for (int r = 0; r < W_ROWS; ++r) acc[r] = 0.0;
    for (int x0 = 0; x0 < nx; x0 += W_XC) {
        __syncthreads();  // the previous chunk's reads are done
        for (int e = threadIdx.x; e < W_XC * W_ROWS; e += W_THREADS) {
            const int x = x0 + e / W_ROWS, i = i0 + e % W_ROWS;
            qs_s[e / W_ROWS][e % W_ROWS] = (x < nx && i < nx) ? qs[(size_t)x * nx + i] : 0.0;
        }
        __syncthreads();
        if (k < nt) {
            double yv[W_XC];  // all W_XC loads of Y in flight at once
#pragma unroll
            for (int xx = 0; xx < W_XC; ++xx)
                yv[xx] = x0 + xx < nx ? yk[(size_t)(x0 + xx) * nt] : 0.0;
#pragma unroll
            for (int xx = 0; xx < W_XC; ++xx)
#pragma unroll
                for (int r = 0; r < W_ROWS; ++r) acc[r] = fma(qs_s[xx][r], yv[xx], acc[r]);
        }
    }
    if (k >= kpad) return;
    double* wk = w + ((size_t)b * nx + i0) * kpad + k;
#pragma unroll
    for (int r = 0; r < W_ROWS; ++r)
        if (i0 + r < nx) wk[(size_t)r * kpad] = acc[r];
}

// Swizzled position (in doubles) of column c of row r in a tile of 128-byte
// rows written by TMA with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte piece
// c/2 of row r sits at piece (c/2) ^ (r % 8).
__device__ __forceinline__ int sw128(int r, int c) {
    return r * 16 + ((((c >> 1) ^ (r & 7)) << 1) | (c & 1));
}

// One BM x BN tile of alpha = W Qt on the FP64 tensor cores, then the
// partial sum of alpha^2 * dinv over the tile (PER_ROW false: one partial
// per block) or over each row of the tile (PER_ROW true: one partial per
// (row m, column tile), at partials[m * tiles_n + column tile]).  TMA fills
// each stage: W's (BM x BK) box and BN/QBOX (BK x QBOX) boxes of Qt, zero
// past every edge.
template <bool PER_ROW>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
quadform_gemm_kernel(const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_qt,
                     const double* __restrict__ dinv, double* __restrict__ partials,
                     int M, int nx, int nt, int kpad, int tiles_n) {
    extern __shared__ double smem_raw[];
    __shared__ double warp_sums[WARPS];
    __shared__ uint64_t full[STAGES];  // stage s holds its chunk when full[s] flips
    double* smem = (double*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wm = (warp / WARPS_N) * WM;
    const int wn = (warp % WARPS_N) * WN;
    const int m0 = (blockIdx.x / tiles_n) * BM;
    const int n0 = (blockIdx.x % tiles_n) * BN;
    const int ktiles = kpad / BK;

    auto fill = [&](int stage, int kt) {
        double* as = smem + stage * STAGE_DOUBLES;
        double* bs = as + BM * BK;
        mbar_expect(&full[stage], STAGE_BYTES);
        tma_load(as, &map_w, kt * BK, m0, &full[stage]);
#pragma unroll
        for (int q = 0; q < BN / QBOX; ++q)
            tma_load(bs + q * BK * QBOX, &map_qt, n0 + q * QBOX, kt * BK, &full[stage]);
    };

    // The DMMA's k index kappa = t + 4u (u = v/2 of an A fragment, v of a B
    // fragment) of k8 step s reads chunk column / row kperm(s, u) below.  A
    // permutation of the chunk's 16 k leaves the sum alone, and this one
    // makes every half-warp's fragment load hit 16 distinct bank pairs of
    // the swizzled tiles, on A and on B.  The fragment offsets inside a
    // stage are fixed per thread: A's row wm + 16a + 8h + g swizzles by g,
    // B's column wn + 8b + g sits in box (wn + 8b) / QBOX.
    auto kperm = [&](int s, int u) { return (s * 4 + u) ^ (t & 1 ? 3 : 0) ^ (t & 2 ? 12 : 0); };
    int a_off[BK / MMA_K][2], b_off[BK / MMA_K][2][2];
#pragma unroll
    for (int s = 0; s < BK / MMA_K; ++s)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            a_off[s][u] = wm * BK + sw128(g, kperm(s, u));
#pragma unroll
            for (int h = 0; h < 2; ++h)
                b_off[s][u][h] = (wn / QBOX) * BK * QBOX + sw128(kperm(s, u), 8 * h + g);
        }

    double acc[MT][NT][4];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
        for (int s = 0; s < STAGES - 1 && s < ktiles; ++s) fill(s, s);

    for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);  // chunk kt has landed
        __syncthreads();  // and every warp is done with chunk kt-1's stage
        const int next = kt + STAGES - 1;
        if (tid == 0 && next < ktiles) fill(next % STAGES, next);

        const double* as = smem + (kt % STAGES) * STAGE_DOUBLES;
        const double* bs = as + BM * BK;
#pragma unroll
        for (int s = 0; s < BK / MMA_K; ++s) {
            double af[MT][4];
            double bf[NT][2];
#pragma unroll
            for (int a = 0; a < MT; ++a)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                    af[a][v] = as[(16 * a + 8 * (v % 2)) * BK + a_off[s][v / 2]];
#pragma unroll
            for (int b = 0; b < NT; ++b)
#pragma unroll
                for (int v = 0; v < 2; ++v)
                    bf[b][v] = bs[(b / 2) * BK * QBOX + b_off[s][v][b % 2]];
#pragma unroll
            for (int a = 0; a < MT; ++a)
#pragma unroll
                for (int b = 0; b < NT; ++b) dmma_16x8x8(acc[a][b], af[a], bf[b]);
        }
    }

    if constexpr (PER_ROW) {
        // alpha^2 * dinv along j for each of the tile's rows: over the 8
        // columns a thread holds, over the 4 lanes (t) that hold the rest of
        // the warp's row, then over the WARPS_N warps that share the row
        __shared__ double row_sums[WARPS_N][BM];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = wm + 16 * a + g + 8 * h;
                const int m = m0 + r;
                double part = 0.0;
                if (m < M) {
                    const double* drow = dinv + (size_t)(m % nx) * nt;
#pragma unroll
                    for (int b = 0; b < NT; ++b) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int j = n0 + wn + 8 * b + 2 * t + e;
                            const double v = acc[a][b][2 * h + e];
                            if (j < nt) part = fma(v * v, drow[j], part);
                        }
                    }
                }
                part += __shfl_xor_sync(0xffffffffu, part, 1);
                part += __shfl_xor_sync(0xffffffffu, part, 2);
                if (t == 0) row_sums[warp % WARPS_N][r] = part;
            }
        }
        __syncthreads();
        if (tid < BM && m0 + tid < M) {
            double s = 0.0;
#pragma unroll
            for (int w = 0; w < WARPS_N; ++w) s += row_sums[w][tid];
            partials[(size_t)(m0 + tid) * tiles_n + blockIdx.x % tiles_n] = s;
        }
        return;
    }

    double part = 0.0;
#pragma unroll
    for (int a = 0; a < MT; ++a) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm + 16 * a + g + 8 * h;
            if (m >= M) continue;
            const double* drow = dinv + (size_t)(m % nx) * nt;
#pragma unroll
            for (int b = 0; b < NT; ++b) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int j = n0 + wn + 8 * b + 2 * t + e;
                    const double v = acc[a][b][2 * h + e];
                    if (j < nt) part = fma(v * v, drow[j], part);
                }
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
    if (lane == 0) warp_sums[warp] = part;
    __syncthreads();
    if (tid == 0) {
        double s = 0.0;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) s += warp_sums[i];
        partials[blockIdx.x] = s;
    }
}

// Block c sums partials[c*n .. c*n + n) into out[c]: each thread a fixed
// strided subset in order, then a tree reduction in shared memory.  Same
// order every run.
__global__ void __launch_bounds__(REDUCE_THREADS)
sum_partials_kernel(const double* __restrict__ partials, int n,
                    double* __restrict__ out) {
    __shared__ double s[REDUCE_THREADS];
    partials += (size_t)blockIdx.x * n;
    double acc = 0.0;
    for (int e = threadIdx.x; e < n; e += REDUCE_THREADS) acc += partials[e];
    s[threadIdx.x] = acc;
    __syncthreads();
    for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
        if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

struct Plan {
    long long kpad, tiles_n, gemm_blocks, n_partials, w_blocks, qt_offset, work_elems;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;  // cuTensorMapEncodeTiled, from libcuda

// A 2D tensor map of a row-major (rows, cols) float64 array with row stride
// ld, box (box_rows, box_cols), 128-byte swizzle, zero fill past the edges.
bool encode_2d(CUtensorMap* map, const double* base, long long rows, long long cols,
               long long ld, int box_rows, int box_cols) {
    const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t stride[1] = {(cuuint64_t)ld * sizeof(double)};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, (void*)base, dim, stride, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// per_row: one partial per (row, column tile) instead of one per block
bool make_plan(int nx, int nt, int ntrials, bool per_row, Plan* p) {
    if (nx <= 0 || nt <= 0 || ntrials <= 0) return false;
    const long long M = (long long)ntrials * nx;
    p->kpad = cdiv(nt, BK) * BK;
    p->tiles_n = cdiv(nt, BN);
    p->gemm_blocks = cdiv(M, BM) * p->tiles_n;
    p->n_partials = per_row ? M * p->tiles_n : p->gemm_blocks;
    p->w_blocks = (long long)ntrials * cdiv(nx, W_ROWS) * cdiv(p->kpad, W_THREADS);
    // W, the partials, then room for a copy of Qt with an even row stride
    p->qt_offset = cdiv(M * p->kpad + p->n_partials, 2) * 2;
    p->work_elems = p->qt_offset + (long long)nt * (nt + 1);
    return M <= INT_MAX && p->gemm_blocks <= INT_MAX && p->w_blocks <= INT_MAX &&
           (long long)nx * p->tiles_n <= INT_MAX;
}

// The W pre-pass, the GEMM with the PER_ROW epilogue and the reduction
// (one block, or one per trial), as quadform_f64 documents them.
template <bool PER_ROW>
int launch(const double* qs, const double* qt, const double* dinv, const double* y,
           double* work, long long work_elems, double* out, int nx, int nt, int ntrials,
           void* stream) {
    Plan p;
    if (!make_plan(nx, nt, ntrials, PER_ROW, &p) || work_elems < p.work_elems ||
        (uintptr_t)work % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int kpad = (int)p.kpad;
    const int M = ntrials * nx;
    double* w = work;
    double* partials = work + (size_t)M * kpad;

    whiten_rows_kernel<<<(int)p.w_blocks, W_THREADS, 0, st>>>(
        qs, y, w, nx, nt, kpad, (int)cdiv(nx, W_ROWS), (int)cdiv(kpad, W_THREADS));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    // A tensor map needs 16-byte aligned rows: else copy Qt to a row stride of nt + 1
    int ldq = nt;
    if (nt % 2 != 0 || (uintptr_t)qt % 16 != 0) {
        ldq = nt + (nt % 2);
        double* qt_even = work + p.qt_offset;
        err = cudaMemcpy2DAsync(qt_even, (size_t)ldq * sizeof(double), qt,
                                (size_t)nt * sizeof(double), (size_t)nt * sizeof(double), nt,
                                cudaMemcpyDeviceToDevice, st);
        if (err != cudaSuccess) return (int)err;
        qt = qt_even;
    }
    CUtensorMap map_w, map_qt;
    if (encode_tiled == nullptr || !encode_2d(&map_w, w, M, kpad, kpad, BM, BK) ||
        !encode_2d(&map_qt, qt, nt, nt, ldq, BK, QBOX))
        return (int)cudaErrorInvalidValue;
    quadform_gemm_kernel<PER_ROW><<<(int)p.gemm_blocks, THREADS, SMEM_BYTES, st>>>(
        map_w, map_qt, dinv, partials, M, nx, nt, kpad, (int)p.tiles_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    if (PER_ROW)
        sum_partials_kernel<<<ntrials, REDUCE_THREADS, 0, st>>>(
            partials, (int)(nx * p.tiles_n), out);
    else
        sum_partials_kernel<<<1, REDUCE_THREADS, 0, st>>>(partials, (int)p.gemm_blocks, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Prepares the kernels on the current device: lets both GEMM epilogues use
// SMEM_BYTES of dynamic shared memory, and finds libcuda's
// cuTensorMapEncodeTiled.  Call once per device before quadform_f64 or
// quadform_rows_f64; returns a cudaError_t (0 on success).
int quadform_f64_init(void) {
    const void* gemms[] = {(const void*)quadform_gemm_kernel<false>,
                           (const void*)quadform_gemm_kernel<true>};
    for (const void* fn : gemms) {
        cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
    }
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode_tiled = (EncodeTiled)fn;
    return 0;
}

// Float64 elements of the scratch buffer quadform_f64 needs (the W array,
// one partial per GEMM block, room for Qt at an even row stride); -1 for a
// shape it does not take.
long long quadform_f64_workspace(int nx, int nt, int ntrials) {
    Plan p;
    return make_plan(nx, nt, ntrials, false, &p) ? p.work_elems : -1;
}

// The same for quadform_rows_f64, whose partials are one per (row, column
// tile): ntrials * nx * ceil(nt / 64) of them.
long long quadform_rows_f64_workspace(int nx, int nt, int ntrials) {
    Plan p;
    return make_plan(nx, nt, ntrials, true, &p) ? p.work_elems : -1;
}

// Launches the three kernels (after a copy of Qt when nt is odd or Qt is
// not 16-byte aligned) on
// `stream`; returns a cudaError_t (0 on success).  qs (nx, nx), qt (nt, nt), dinv (nx, nt), y (ntrials, nx, nt):
// row-major, contiguous float64 on the current device; work holds
// work_elems >= quadform_f64_workspace(nx, nt, ntrials) doubles, 16-byte
// aligned; out one double.
int quadform_f64(const double* qs, const double* qt, const double* dinv, const double* y,
                 double* work, long long work_elems, double* out, int nx, int nt,
                 int ntrials, void* stream) {
    return launch<false>(qs, qt, dinv, y, work, work_elems, out, nx, nt, ntrials, stream);
}

// As quadform_f64, with one output per trial: out holds ntrials doubles,
// out[b] = sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij, and work holds
// quadform_rows_f64_workspace(nx, nt, ntrials) doubles.
int quadform_rows_f64(const double* qs, const double* qt, const double* dinv, const double* y,
                      double* work, long long work_elems, double* out, int nx, int nt,
                      int ntrials, void* stream) {
    return launch<true>(qs, qt, dinv, y, work, work_elems, out, nx, nt, ntrials, stream);
}

const char* quadform_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
