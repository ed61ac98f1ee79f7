// Fused Kronecker-whitened quadratic form, float64, for sm_90a.
//
//     out = sum_b sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij
//
// Replaces the Pallas TPU kernel gpcsd_tpu/ops/pallas/quadform.py
// (_quadform_kernel, pallas_call at :66): the quadratic term of the
// Kronecker marginal likelihood.  Like it, the whitened (ntrials, nx, nt)
// array alpha never reaches device memory.  Unlike it, everything is
// float64 with float64 accumulation: at the auditory paper configuration
// the term is ~1.4e6 and the log-joint ~2.14e6, and the likelihood is held
// to 1e-8 relative, which an f32 sum of 1.44e6 squares cannot meet.
//
// What bounds it: at nx=24, nt=600, ntrials=100 the two products are
// ~1.8 GFLOP of f64 per call (17 MFLOP per trial for (.)Qt) against
// 11.5 MB of Y and 2.9 MB of Qt read, ~125 FLOP per byte: the kernel is
// bound by f64 arithmetic, not by memory bandwidth.
//
// Design.  Qt (2.9 MB in f64) does not fit in a block's 227 KB of shared
// memory, so it is streamed, not held resident as VMEM held it on the TPU.
// The grid is (ntrials x ceil(nx/TI) x ceil(nt/TJ)) blocks; each owns the
// alpha tile [i0:i0+TI, j0:j0+TJ] of one trial and loops over k in chunks
// of TK: it forms W = Qs[:, i-tile]^T Y_b[:, k-chunk] in shared memory,
// stages Qt[k-chunk, j-tile] in shared memory, and accumulates alpha in
// registers (2 x 4 values per thread).  The epilogue reduces
// sum(alpha^2 * dinv) over the tile and writes one partial per block.  The
// TPU's sequential grid carried one scalar across steps; Hopper blocks run
// in parallel and in no order, so a second single-block kernel sums the
// partials in a fixed order and the result is the same from run to run.
// Ragged edges (nt not a multiple of TJ or TK, nx not a multiple of TI) are
// masked with zeros on load and skipped in the epilogue.  W is recomputed
// by each of the ceil(nt/TJ) column tiles and tiles are padded (TI=32 rows
// for nx=24), so at the main shape the kernel executes ~1.9x the useful
// FLOPs; DMMA tiles and TMA staging are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TI = 32;           // alpha rows (spatial eigen-index i) per block
constexpr int TJ = 64;           // alpha columns (temporal eigen-index j) per block
constexpr int TK = 32;           // depth of one k-chunk (time sample k)
constexpr int THREADS = 256;     // 16 x 16 threads over the TI x TJ tile
constexpr int RI = TI / 16;      // alpha rows per thread
constexpr int RJ = TJ / 16;      // alpha columns per thread
constexpr int WARPS = THREADS / 32;
constexpr int REDUCE_THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // 227 KB a block can opt in to on sm_90

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline size_t dyn_smem_bytes(int nx) {
    return (size_t)(nx * TI + TI * TK + TK * TJ) * sizeof(double);
}

__global__ void __launch_bounds__(THREADS)
quadform_partials_kernel(const double* __restrict__ qs,
                         const double* __restrict__ qt,
                         const double* __restrict__ dinv,
                         const double* __restrict__ y,
                         double* __restrict__ partials,
                         int nx, int nt, int tiles_i, int tiles_j) {
    extern __shared__ double smem[];
    double* qs_s = smem;              // [nx][TI]  Qs[:, i0:i0+TI]
    double* w_s = qs_s + nx * TI;     // [TI][TK]  Qs[:, i-tile]^T Y_b[:, k-chunk]
    double* qt_s = w_s + TI * TK;     // [TK][TJ]  Qt[k-chunk, j0:j0+TJ]
    __shared__ double warp_sums[WARPS];

    int bid = blockIdx.x;
    const int tj = bid % tiles_j;
    bid /= tiles_j;
    const int ti = bid % tiles_i;
    const int b = bid / tiles_i;
    const int i0 = ti * TI;
    const int j0 = tj * TJ;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const double* yb = y + (size_t)b * nx * nt;

    for (int e = tid; e < nx * TI; e += THREADS) {
        const int x = e / TI, ii = e % TI;
        qs_s[e] = (i0 + ii < nx) ? qs[(size_t)x * nx + i0 + ii] : 0.0;
    }

    double acc[RI][RJ];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RJ; ++c) acc[r][c] = 0.0;

    for (int k0 = 0; k0 < nt; k0 += TK) {
        // qs_s is written (first pass) and the previous chunk's w_s/qt_s
        // reads are finished before they are overwritten
        __syncthreads();
        // W[ii][kk]: one warp per row ii, consecutive kk -> coalesced Y reads
        for (int e = tid; e < TI * TK; e += THREADS) {
            const int ii = e / TK, kk = e % TK;
            const int k = k0 + kk;
            double s = 0.0;
            if (k < nt) {
                for (int x = 0; x < nx; ++x)
                    s = fma(qs_s[x * TI + ii], yb[(size_t)x * nt + k], s);
            }
            w_s[e] = s;
        }
        for (int e = tid; e < TK * TJ; e += THREADS) {
            const int kk = e / TJ, jj = e % TJ;
            const int k = k0 + kk, j = j0 + jj;
            qt_s[e] = (k < nt && j < nt) ? qt[(size_t)k * nt + j] : 0.0;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
            double a[RI], q[RJ];
#pragma unroll
            for (int r = 0; r < RI; ++r) a[r] = w_s[(ty + 16 * r) * TK + kk];
#pragma unroll
            for (int c = 0; c < RJ; ++c) q[c] = qt_s[kk * TJ + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < RI; ++r)
#pragma unroll
                for (int c = 0; c < RJ; ++c) acc[r][c] = fma(a[r], q[c], acc[r][c]);
        }
    }

    double part = 0.0;
#pragma unroll
    for (int r = 0; r < RI; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= nx) continue;
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
            const int j = j0 + tx + 16 * c;
            if (j < nt) part += acc[r][c] * acc[r][c] * dinv[(size_t)i * nt + j];
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        part += __shfl_down_sync(0xffffffffu, part, off);
    if (tid % 32 == 0) warp_sums[tid / 32] = part;
    __syncthreads();
    if (tid == 0) {
        double s = 0.0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += warp_sums[w];
        partials[blockIdx.x] = s;
    }
}

// One block: each thread sums a fixed strided subset in order, then a tree
// reduction in shared memory.  Same order every run.
__global__ void __launch_bounds__(REDUCE_THREADS)
sum_partials_kernel(const double* __restrict__ partials, int n,
                    double* __restrict__ out) {
    __shared__ double s[REDUCE_THREADS];
    double acc = 0.0;
    for (int e = threadIdx.x; e < n; e += REDUCE_THREADS) acc += partials[e];
    s[threadIdx.x] = acc;
    __syncthreads();
    for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
        if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
        __syncthreads();
    }
    if (threadIdx.x == 0) *out = s[0];
}

}  // namespace

extern "C" {

// Number of float64 partials the caller allocates for quadform_f64.
int quadform_f64_num_blocks(int nx, int nt, int ntrials) {
    return ntrials * cdiv(nx, TI) * cdiv(nt, TJ);
}

// Largest nx whose Qs tile fits in a block's shared memory.
int quadform_f64_max_nx(void) {
    const size_t fixed = (size_t)(TI * TK + TK * TJ + WARPS) * sizeof(double);
    return (int)((MAX_SMEM - fixed) / (TI * sizeof(double)));
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 on success).
// qs (nx, nx), qt (nt, nt), dinv (nx, nt), y (ntrials, nx, nt): row-major,
// contiguous float64 on the current device; partials holds
// quadform_f64_num_blocks(nx, nt, ntrials) doubles; out one double.
int quadform_f64(const double* qs, const double* qt, const double* dinv,
                 const double* y, double* partials, double* out,
                 int nx, int nt, int ntrials, void* stream) {
    if (nx <= 0 || nt <= 0 || ntrials <= 0 || nx > quadform_f64_max_nx())
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = dyn_smem_bytes(nx);
    cudaError_t err = cudaFuncSetAttribute(
        quadform_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles_i = cdiv(nx, TI), tiles_j = cdiv(nt, TJ);
    const int nblocks = quadform_f64_num_blocks(nx, nt, ntrials);
    quadform_partials_kernel<<<nblocks, THREADS, smem, st>>>(
        qs, qt, dinv, y, partials, nx, nt, tiles_i, tiles_j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<1, REDUCE_THREADS, 0, st>>>(partials, nblocks, out);
    return (int)cudaGetLastError();
}

const char* quadform_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
