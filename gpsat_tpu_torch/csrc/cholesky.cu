// Full lower Cholesky factor of [batch, N, N] f32 SPD matrices, N a multiple
// of 128 up to 1024, right-looking with 128-wide block steps.
//
// Replaces the Pallas TPU kernel gpsat_tpu/ops/pallas/cholesky.py
// (_chol_kernel with _unblocked_chol_block and _tri_inv_block, called through
// _pallas_chol_batched). Same contract: per 128-block step the factor of the
// diagonal block (rsqrt pivot, no clamp: a non-positive pivot gives NaN in
// that matrix and in no other), the panel below it times the inverse of that
// factor transposed, and the trailing matrix minus the panel times its
// transpose; an identity comes back exactly; the strict upper triangle of
// the output is zero. All products are plain f32 fused multiply-adds: no
// tensor cores, so no reduced-precision inputs.
//
// What bounds it on an H100: at the profiled path's [512, 512, 512] it reads
// K and writes L, 2 * 512 * 1 MB = 1.07 GB, 0.32 ms at 3.35 TB/s, and does
// 512 * 512^3 / 3 = 22.9 GFLOP, 0.34 ms at the 67 TFLOP/s f32 peak: about
// even, operations by a little. The matrix (1 MB at N=512) stays in global
// memory, the L2 holding the panel between kernels; each block step k is two
// kernels on the caller's stream:
//
//   diag      one thread block per matrix, two per SM: the 128x128 diagonal
//             block's factor and the inverse of it, by the blocked 128-factor
//             of factor128.cuh with the NaN pivot (kClamp = false); L11 and
//             zeros right of it in its 128 rows go out as float4. Then the
//             panel below, L21 = A21 * W11^T as a product by 32x32 blocks
//             that skips W11's upper blocks (10 of 16), 64 rows at a time
//             double-buffered by cp.async through the freed A region, the
//             results stored from registers. The last step has no panel and
//             skips the inverse.
//   trailing  one thread block per 128x128 tile of the trailing lower
//             triangle: C -= L21_I * L21_J^T, each thread an 8x8 register
//             tile (a warp a 32x64 region) that starts as C, K = 128 in
//             chunks of 32 brought in by cp.async and double-buffered, float4
//             shared loads from rows of stride 36 floats (consecutive rows 4
//             banks apart); on a diagonal tile the two warps whose region
//             lies above the diagonal compute nothing and the others write
//             the lower triangle only. No register cap: at 128 registers
//             (two blocks per SM) it spilled and ran 3-7 % slower than at
//             one block per SM without spills, on an H100.
//
// Step 0 reads K where a later step reads the output, so no copy pass runs:
// the diagonal kernel writes every element of the diagonal blocks and the
// zeros above them, the trailing kernel every element of the lower tiles.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libcholesky.so cholesky.cu

#include <cuda_runtime.h>

#include "factor128.cuh"

namespace {

namespace f128 = gpsat::f128;
using f128::ld4;
using f128::st4;

constexpr int T = f128::T;       // block step and trailing tile side
constexpr int NB = f128::NB;
constexpr int MAX_N = 1024;
constexpr int MAX_DEVICES = 64;

constexpr int TRAIL_THREADS = 256;
constexpr int KC = 32;                             // K chunk of the trailing product
constexpr int LDS = KC + 4;                        // a chunk row's stride in shared memory
constexpr int CHUNK_FLOATS = T * LDS;              // one operand's chunk: 128 rows
constexpr size_t TRAIL_SMEM = 2 * 2 * CHUNK_FLOATS * sizeof(float);  // two stages of two operands

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The panel below the diagonal block at (k, k), by all threads of the
// diagonal kernel, once W holds the block's inverse and A is free: L21 =
// A21 W^T by 32x32 blocks, L_sJ = sum_{K<=J} A_sK W_JK^T, 64 rows at a time
// through the two halves of A (the next 64 rows' copy in flight while these
// are multiplied). Group g takes strip s = g % 2 of the 64 rows and column
// blocks {3, 0} (g < 2) or {2, 1}: five block products each. Results go
// from registers to the output.
__device__ __forceinline__ void panel(const float* S, float* D, float* A, float* W, int n, int k) {
    constexpr int ROWS = T / 2;                      // rows per chunk
    constexpr int ROW4 = T / 4;                      // float4 per row
    constexpr int HALF = ROWS * f128::LDA;           // one buffer
    constexpr int COPIES = ROWS * ROW4 / f128::THREADS;
    const int tid = threadIdx.x;
    const int g = tid % f128::GROUP, grp = tid / f128::GROUP, r0 = g / 8, c0 = g % 8;
    const int s = grp % 2, J0 = grp < 2 ? 3 : 2;     // column blocks J0 and 3 - J0
    const int chunks = (n - k - T) / ROWS;

    auto copy = [&](int chunk) {
        float* buf = A + (chunk % 2) * HALF;
        const float* src = S + static_cast<size_t>(k + T + chunk * ROWS) * n + k;
#pragma unroll
        for (int u = 0; u < COPIES; ++u) {
            const int e = tid + u * f128::THREADS, r = e / ROW4, c = (e % ROW4) * 4;
            cp_async16(buf + r * f128::LDA + c, src + static_cast<size_t>(r) * n + c);
        }
        cp_async_commit();
    };

    copy(0);
#pragma unroll 1
    for (int chunk = 0; chunk < chunks; ++chunk) {
        if (chunk + 1 < chunks) {
            copy(chunk + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* X = A + (chunk % 2) * HALF + s * NB * f128::LDA;
        float* out = D + static_cast<size_t>(k + T + chunk * ROWS + s * NB) * n + k;
#pragma unroll 1
        for (int t = 0; t < 2; ++t) {
            const int J = t == 0 ? J0 : 3 - J0;
            float acc[4][4];
            f128::zero_tile(acc);
            for (int Kb = 0; Kb <= J; ++Kb)
                f128::tile_abt<false>(acc, X + Kb * NB, f128::LDA, f128::wtile(W, J, Kb),
                                      f128::LDW, r0, c0);
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int p = 0; p < 4; ++p) out[static_cast<size_t>(r0 + 8 * q) * n + J * NB + c0 + 8 * p] = acc[q][p];
        }
        __syncthreads();  // the buffer is read before the copy two chunks on overwrites it
    }
}

// Factor the diagonal block at (k, k) of every matrix and, with kPanel, the
// panel below it. src is K at step 0 and out after it.
template <bool kPanel>
__global__ void __launch_bounds__(f128::THREADS, 2)
chol_diag_kernel(const float* src, float* out, int n, int k) {
    extern __shared__ __align__(16) float smem[];
    float* A = smem;                      // the diagonal block; then two buffers of 64 panel rows
    float* W = smem + f128::A_FLOATS;     // the ten lower tiles of the block's inverse
    float* buf = W + f128::W_FLOATS;      // the diagonal step's broadcast buffers

    const int tid = threadIdx.x;
    const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
    const float* S = src + base;
    float* D = out + base;
    constexpr int ROW4 = T / 4;           // float4 per row of a 128-block

    // the block's lower 32x32 blocks into A, zeros above the diagonal (after
    // step 0 the trailing kernel has written the lower triangle only)
    for (int e = tid; e < T * ROW4; e += f128::THREADS) {
        const int r = e / ROW4, c = (e % ROW4) * 4;
        if (c / NB <= r / NB) {
            float4 v = ld4(S + static_cast<size_t>(k + r) * n + k + c);
            if (c > r) v.x = 0.0f;
            if (c + 1 > r) v.y = 0.0f;
            if (c + 2 > r) v.z = 0.0f;
            if (c + 3 > r) v.w = 0.0f;
            st4(A + r * f128::LDA + c, v);
        }
    }
    __syncthreads();

    f128::factor</*kClamp=*/false>(A, W, buf);

    // L11 out (zeros in its upper blocks), and zeros right of it in its rows
    for (int e = tid; e < T * ROW4; e += f128::THREADS) {
        const int r = e / ROW4, c = (e % ROW4) * 4;
        st4(D + static_cast<size_t>(k + r) * n + k + c, c / NB <= r / NB ? ld4(A + r * f128::LDA + c) : zero4());
    }
    const int right4 = (n - k - T) / 4;
    for (int e = tid; e < T * right4; e += f128::THREADS) {
        const int r = e / right4, c = (e % right4) * 4;
        st4(D + static_cast<size_t>(k + r) * n + k + T + c, zero4());
    }
    if constexpr (kPanel) {
        f128::invert(A, W);  // W = L11^-1; A is free
        panel(S, D, A, W, n, k);
    }
}

// Columns chunk * 32 .. chunk * 32 + 31 of the 128 panel rows at Pa (and,
// unless diag, at Pb) into one stage: 8 float4 per row, 4 copies per thread
// and operand, in one cp.async group.
__device__ __forceinline__ void load_chunk(float* stage, const float* Pa, const float* Pb, bool diag, int n,
                                           int chunk, int tid) {
    constexpr int ROW4 = KC / 4;
    const int r = tid / ROW4, c = (tid % ROW4) * 4;
    const int off = r * n + chunk * KC + c;      // within one matrix: fits an int
    const int step = TRAIL_THREADS / ROW4 * n;   // 32 rows
    float* s = stage + r * LDS + c;
#pragma unroll
    for (int u = 0; u < T * ROW4 / TRAIL_THREADS; ++u) {
        cp_async16(s + u * (TRAIL_THREADS / ROW4) * LDS, Pa + off + u * step);
        if (!diag) cp_async16(s + CHUNK_FLOATS + u * (TRAIL_THREADS / ROW4) * LDS, Pb + off + u * step);
    }
    cp_async_commit();
}

// Trailing matrix below and right of the block step at k: C <- C - P P^T on
// its lower triangle, one 128x128 tile per thread block. The panel P (the
// columns k .. k + 127) is read from out; C from csrc, which is K at step 0
// and out after it; the result goes to out.
__global__ void __launch_bounds__(TRAIL_THREADS, 1)
chol_trailing_kernel(const float* csrc, float* out, int n, int k) {
    extern __shared__ __align__(16) float smem[];  // [stage][operand][128][LDS]

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int m = (n - k - T) / T;
    const int tiles = m * (m + 1) / 2;
    const int b = blockIdx.x / tiles;
    int tj = blockIdx.x % tiles, ti = 0;
    while (tj > ti) {  // tile number -> (ti, tj) with ti >= tj, row by row
        tj -= ti + 1;
        ++ti;
    }
    const bool diag = ti == tj;
    const size_t base = static_cast<size_t>(b) * n * n;
    const int row0 = k + T + ti * T, col0 = k + T + tj * T;
    const float* Pa = out + base + static_cast<size_t>(row0) * n + k;  // the tile's rows of the panel
    const float* Pb = out + base + static_cast<size_t>(col0) * n + k;  // its columns' rows

    // warp (wr, wc): rows 32 wr .. 32 wr + 31, columns 64 wc .. 64 wc + 63 of
    // the tile; lane (lr, lc): rows 32 wr + lr + 4 i, columns 64 wc + lc + 8 j
    const int wr = warp / 2, wc = warp % 2, lr = lane / 8, lc = lane % 8;
    const bool active = !diag || 64 * wc <= 32 * wr + 31;
    load_chunk(smem, Pa, Pb, diag, n, 0, tid);

    // acc starts as C (above the diagonal of a diagonal tile: never read or
    // written); its loads overlap the first chunk's copy
    const float* C = csrc + base + static_cast<size_t>(row0) * n + col0;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int r = 32 * wr + lr + 4 * i, c = 64 * wc + lc + 8 * j;
            acc[i][j] = active && (!diag || r >= c) ? C[static_cast<size_t>(r) * n + c] : 0.0f;
        }

    constexpr int CHUNKS = T / KC;
#pragma unroll 1
    for (int chunk = 0; chunk < CHUNKS; ++chunk) {
        if (chunk + 1 < CHUNKS) {
            load_chunk(smem + ((chunk + 1) & 1) * 2 * CHUNK_FLOATS, Pa, Pb, diag, n, chunk + 1, tid);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
            const float* sa = smem + (chunk & 1) * 2 * CHUNK_FLOATS;
            const float* sb = diag ? sa : sa + CHUNK_FLOATS;
            const float* xa = sa + (32 * wr + lr) * LDS;
            const float* yb = sb + (64 * wc + lc) * LDS;
            // acc -= x y^T, the rows in two halves of four (fewer live
            // registers); the negation is an FFMA operand modifier
#pragma unroll
            for (int kk = 0; kk < KC; kk += 4) {
#pragma unroll
                for (int h = 0; h < 8; h += 4) {
                    float4 x[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) x[i] = ld4(xa + 4 * (h + i) * LDS + kk);
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const float4 y = ld4(yb + 8 * j * LDS + kk);
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            float& a = acc[h + i][j];
                            a = fmaf(-x[i].x, y.x, a);
                            a = fmaf(-x[i].y, y.y, a);
                            a = fmaf(-x[i].z, y.z, a);
                            a = fmaf(-x[i].w, y.w, a);
                        }
                    }
                }
            }
        }
        __syncthreads();  // the stage is read before the next round's copy overwrites it
    }

    if (!active) return;
    float* D = out + base + static_cast<size_t>(row0) * n + col0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = 32 * wr + lr + 4 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = 64 * wc + lc + 8 * j;
            if (!diag || r >= c) D[static_cast<size_t>(r) * n + c] = acc[i][j];
        }
    }
}

bool configured[MAX_DEVICES];  // the shared-memory opt-in, set once per device

cudaError_t configure() {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && configured[dev]) return cudaSuccess;
    constexpr cudaFuncAttribute kDyn = cudaFuncAttributeMaxDynamicSharedMemorySize;
    constexpr int kDiag = static_cast<int>(f128::SMEM_BYTES), kTrail = static_cast<int>(TRAIL_SMEM);
    err = cudaFuncSetAttribute(chol_diag_kernel<true>, kDyn, kDiag);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(chol_diag_kernel<false>, kDyn, kDiag);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(chol_trailing_kernel, kDyn, kTrail);
    if (err == cudaSuccess && dev < MAX_DEVICES) configured[dev] = true;
    return err;
}

inline bool fits_grid(long long blocks) { return blocks > 0 && blocks <= 2147483647LL; }

}  // namespace

extern "C" {

// K, out: device pointers to [batch, n, n] contiguous f32, 16-byte aligned,
// not overlapping; stream: a cudaStream_t. Launches every kernel of the
// factorisation on that stream and returns the first cudaError_t that is not
// 0 (0 on success).
int gpsat_cholesky_f32(const void* K, void* out, int batch, int n, void* stream) {
    if (batch <= 0) return 0;
    if (n < T || n > MAX_N || n % T != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int worst_tiles = (MAX_N / T - 1) * (MAX_N / T) / 2;
    if (!fits_grid(static_cast<long long>(batch) * worst_tiles)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = configure();
    if (err != cudaSuccess) return static_cast<int>(err);

    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* src = static_cast<const float*>(K);
    float* o = static_cast<float*>(out);
    for (int k = 0; k < n; k += T) {
        if (k + T == n) {
            chol_diag_kernel<false><<<batch, f128::THREADS, f128::SMEM_BYTES, st>>>(src, o, n, k);
            return static_cast<int>(cudaGetLastError());
        }
        chol_diag_kernel<true><<<batch, f128::THREADS, f128::SMEM_BYTES, st>>>(src, o, n, k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        const int m = (n - k - T) / T;
        chol_trailing_kernel<<<batch * (m * (m + 1) / 2), TRAIL_THREADS, TRAIL_SMEM, st>>>(src, o, n, k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        src = o;
    }
    return 0;
}

// How many blocks of the diagonal kernel (with its panel) and of the
// trailing kernel the current device holds on one SM at once.
int gpsat_cholesky_blocks_per_sm(int* diag, int* trailing) {
    cudaError_t err = configure();
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(diag, chol_diag_kernel<true>, f128::THREADS,
                                                            f128::SMEM_BYTES);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(trailing, chol_trailing_kernel, TRAIL_THREADS, TRAIL_SMEM);
    return static_cast<int>(err);
}

}  // extern "C"
