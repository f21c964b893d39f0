// Full lower Cholesky factor of [batch, N, N] f32 SPD matrices, N a multiple
// of 128 up to 1024, right-looking with 128-wide block steps.
//
// Replaces the Pallas TPU kernel gpsat_tpu/ops/pallas/cholesky.py
// (_chol_kernel with _unblocked_chol_block and _tri_inv_block, called through
// _pallas_chol_batched). Same contract: for each 128x128 diagonal block, an
// unblocked factorisation (rsqrt pivot, no clamp: a non-positive pivot gives
// NaN in that matrix and in no other), the inverse of that factor, the panel
// below it times the inverse transposed, and the trailing matrix minus the
// panel times its transpose; the strict upper triangle of the output is
// zero. All products are plain f32 fused multiply-adds: no tensor cores, so
// no reduced-precision inputs.
//
// The TPU kernel keeps the whole matrix in on-chip memory. Here a 512^2
// matrix is 1 MB and a thread block has 227 KB of shared memory, so the
// matrix stays in global memory (the L2 holds 50 MB of it) and each block
// step is three kernels on the caller's stream, after one copy pass:
//
//   copy      out = lower triangle of K, zeros above (float4, grid-stride)
//   diag      one thread block per matrix: the diagonal block and, unless it
//             is the last, its inverse, both in shared memory
//             (tri_block128.cuh); the inverse goes to a [batch, 128, 128]
//             scratch tensor
//   panel     one thread block per 64-row strip of the panel: strip and
//             inverse in shared memory, 4x8 outputs per thread, in place
//   trailing  one thread block per 64x64 tile of the trailing lower triangle:
//             the two 64x128 panel strips in shared memory, 4x4 outputs per
//             thread; tiles above the diagonal are never touched
//
// What bounds it on an H100: at the profiled path's [512, 512, 512] it reads
// K and writes L, 2 * 512 * 1 MB = 1.07 GB, 0.32 ms at 3.35 TB/s, and does
// 512 * 512^3 / 3 = 22.9 GFLOP, 0.34 ms at the 67 TFLOP/s f32 peak: about
// even, operations by a little. The design above is simple and right first:
// it re-reads the panel from L2 for every tile, leaves the SMs one block each
// during the diagonal step, and has no software pipelining. Those are for a
// later change.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libcholesky.so cholesky.cu

#include <cuda_runtime.h>

#include "tri_block128.cuh"

namespace {

using gpsat::LD128;
using gpsat::T128;

constexpr int MAX_N = 1024;
constexpr int TILE = 64;  // rows of a panel strip, side of a trailing tile

constexpr int COPY_THREADS = 256;
constexpr int DIAG_THREADS = 512;
constexpr int GEMM_THREADS = 256;

constexpr size_t DIAG_SMEM = 2 * gpsat::BLOCK128_BYTES;                        // A and its inverse
constexpr size_t PANEL_SMEM = (TILE + T128) * LD128 * sizeof(float);          // strip and inverse
constexpr size_t TRAIL_SMEM = 2 * static_cast<size_t>(TILE) * LD128 * sizeof(float);  // two strips

// out = tril(K) for every matrix; n is a multiple of 4, so a float4 never
// straddles two rows.
__global__ void __launch_bounds__(COPY_THREADS)
chol_copy_lower_kernel(const float4* __restrict__ K, float4* __restrict__ out, size_t total4, int n) {
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total4; i += stride) {
        const size_t e = i * 4;
        const int c = static_cast<int>(e % n);
        const int r = static_cast<int>((e / n) % n);
        float4 v = K[i];
        if (c > r) v.x = 0.0f;
        if (c + 1 > r) v.y = 0.0f;
        if (c + 2 > r) v.z = 0.0f;
        if (c + 3 > r) v.w = 0.0f;
        out[i] = v;
    }
}

// Factor the diagonal block at (k, k) of every matrix in place; with
// kInverse also write its inverse to winv[b] (zeros above the diagonal).
template <bool kInverse>
__global__ void __launch_bounds__(DIAG_THREADS)
chol_diag_kernel(float* __restrict__ out, float* __restrict__ winv, int n, int k) {
    extern __shared__ float smem[];
    float* A = smem;
    float* Wi = smem + T128 * LD128;

    const int tid = threadIdx.x;
    float* M = out + static_cast<size_t>(blockIdx.x) * n * n + static_cast<size_t>(k) * n + k;

    for (int e = tid; e < T128 * T128; e += DIAG_THREADS) {
        const int r = e / T128, c = e % T128;
        A[r * LD128 + c] = M[static_cast<size_t>(r) * n + c];  // zeros above the diagonal, never read
        if constexpr (kInverse) Wi[r * LD128 + c] = 0.0f;
    }
    __syncthreads();

    gpsat::factor_block128</*kClamp=*/false, kInverse, DIAG_THREADS>(A, Wi);

    float* Wout = winv + static_cast<size_t>(blockIdx.x) * T128 * T128;
    for (int e = tid; e < T128 * T128; e += DIAG_THREADS) {
        const int r = e / T128, c = e % T128;
        if (r >= c) M[static_cast<size_t>(r) * n + c] = A[r * LD128 + c];
        if constexpr (kInverse) Wout[e] = Wi[r * LD128 + c];  // rows were filled up to the diagonal only
    }
}

// Panel below the diagonal block at (k, k): P <- P W^T, W the block's
// inverse, one 64-row strip per thread block, in place (the strip is in
// shared memory before any of it is written).
__global__ void __launch_bounds__(GEMM_THREADS)
chol_panel_kernel(float* __restrict__ out, const float* __restrict__ winv, int n, int k) {
    extern __shared__ float smem[];
    float* P = smem;                  // [TILE][LD128]
    float* W = smem + TILE * LD128;   // [T128][LD128]

    const int tid = threadIdx.x;
    const int strips = (n - k - T128) / TILE;
    const int b = blockIdx.x / strips, s = blockIdx.x % strips;
    float* Pg = out + static_cast<size_t>(b) * n * n + static_cast<size_t>(k + T128 + s * TILE) * n + k;
    const float* Wg = winv + static_cast<size_t>(b) * T128 * T128;

    for (int e = tid; e < TILE * T128; e += GEMM_THREADS) {
        const int r = e / T128, c = e % T128;
        P[r * LD128 + c] = Pg[static_cast<size_t>(r) * n + c];
    }
    for (int e = tid; e < T128 * T128; e += GEMM_THREADS) W[(e / T128) * LD128 + e % T128] = Wg[e];
    __syncthreads();

    // thread (ty, tx) of 16 x 16: rows 4 ty .. 4 ty + 3, columns tx + 16 q
    const int ty = tid / 16, tx = tid % 16;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;
    for (int j = 0; j < T128; ++j) {
        float p[4], w[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = P[(4 * ty + i) * LD128 + j];
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = W[(tx + 16 * q) * LD128 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[i][q] += p[i] * w[q];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) Pg[static_cast<size_t>(4 * ty + i) * n + tx + 16 * q] = acc[i][q];
}

// Trailing matrix below and right of the block step at k: C <- C - P P^T on
// its lower triangle, one 64x64 tile per thread block.
__global__ void __launch_bounds__(GEMM_THREADS)
chol_trailing_kernel(float* __restrict__ out, int n, int k) {
    extern __shared__ float smem[];
    float* Pa = smem;                  // rows of the tile:    [TILE][LD128]
    float* Pb = smem + TILE * LD128;   // columns of the tile: [TILE][LD128]

    const int tid = threadIdx.x;
    const int nt = (n - k - T128) / TILE;
    const int tiles = nt * (nt + 1) / 2;
    const int b = blockIdx.x / tiles;
    int tj = blockIdx.x % tiles, ti = 0;
    while (tj > ti) {  // tile number -> (ti, tj) with ti >= tj, row by row
        tj -= ti + 1;
        ++ti;
    }
    float* M = out + static_cast<size_t>(b) * n * n;
    const int r0 = k + T128 + ti * TILE, c0 = k + T128 + tj * TILE;

    for (int e = tid; e < TILE * T128; e += GEMM_THREADS) {
        const int r = e / T128, c = e % T128;
        Pa[r * LD128 + c] = M[static_cast<size_t>(r0 + r) * n + k + c];
        Pb[r * LD128 + c] = M[static_cast<size_t>(c0 + r) * n + k + c];
    }
    __syncthreads();

    // thread (ty, tx) of 16 x 16: rows ty + 16 i, columns tx + 16 q
    const int ty = tid / 16, tx = tid % 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    for (int j = 0; j < T128; ++j) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Pa[(ty + 16 * i) * LD128 + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) bb[q] = Pb[(tx + 16 * q) * LD128 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] += a[i] * bb[q];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * q;
            if (r >= c) M[static_cast<size_t>(r) * n + c] -= acc[i][q];
        }
}

inline bool fits_grid(long long blocks) { return blocks > 0 && blocks <= 2147483647LL; }

}  // namespace

extern "C" {

// K, out: device pointers to [batch, n, n] contiguous f32, 16-byte aligned;
// winv: scratch of [batch, 128, 128] f32 (unused when n == 128); stream: a
// cudaStream_t. Launches every kernel of the factorisation on that stream and
// returns the first cudaError_t that is not 0 (0 on success).
int gpsat_cholesky_f32(const void* K, void* out, void* winv, int batch, int n, void* stream) {
    if (batch <= 0) return 0;
    if (n < T128 || n > MAX_N || n % T128 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int worst_tiles = ((MAX_N - T128) / TILE) * ((MAX_N - T128) / TILE + 1) / 2;
    if (!fits_grid(static_cast<long long>(batch) * worst_tiles)) return static_cast<int>(cudaErrorInvalidValue);

    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    float* w = static_cast<float*>(winv);
    cudaError_t err;

#define CHOL_TRY(call)                                       \
    do {                                                      \
        err = (call);                                         \
        if (err != cudaSuccess) return static_cast<int>(err); \
    } while (0)

    constexpr cudaFuncAttribute kDyn = cudaFuncAttributeMaxDynamicSharedMemorySize;
    CHOL_TRY(cudaFuncSetAttribute(chol_diag_kernel<true>, kDyn, static_cast<int>(DIAG_SMEM)));
    CHOL_TRY(cudaFuncSetAttribute(chol_diag_kernel<false>, kDyn, static_cast<int>(DIAG_SMEM)));
    CHOL_TRY(cudaFuncSetAttribute(chol_panel_kernel, kDyn, static_cast<int>(PANEL_SMEM)));
    CHOL_TRY(cudaFuncSetAttribute(chol_trailing_kernel, kDyn, static_cast<int>(TRAIL_SMEM)));

    const size_t total4 = static_cast<size_t>(batch) * n * n / 4;
    const size_t want = (total4 + COPY_THREADS - 1) / COPY_THREADS;
    const int copy_blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    chol_copy_lower_kernel<<<copy_blocks, COPY_THREADS, 0, st>>>(
        static_cast<const float4*>(K), static_cast<float4*>(out), total4, n);
    CHOL_TRY(cudaGetLastError());

    for (int k = 0; k < n; k += T128) {
        if (k + T128 == n) {
            chol_diag_kernel<false><<<batch, DIAG_THREADS, DIAG_SMEM, st>>>(o, w, n, k);
            CHOL_TRY(cudaGetLastError());
            break;
        }
        chol_diag_kernel<true><<<batch, DIAG_THREADS, DIAG_SMEM, st>>>(o, w, n, k);
        CHOL_TRY(cudaGetLastError());
        const int nt = (n - k - T128) / TILE;
        chol_panel_kernel<<<batch * nt, GEMM_THREADS, PANEL_SMEM, st>>>(o, w, n, k);
        CHOL_TRY(cudaGetLastError());
        chol_trailing_kernel<<<batch * (nt * (nt + 1) / 2), GEMM_THREADS, TRAIL_SMEM, st>>>(o, n, k);
        CHOL_TRY(cudaGetLastError());
    }
#undef CHOL_TRY
    return 0;
}

}  // extern "C"
