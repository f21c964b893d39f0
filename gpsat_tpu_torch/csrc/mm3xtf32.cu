// Batched f32 matrix product by the 3xTF32 split: C[b] = op(A[b]) op(B[b]).
//
// Replaces no Pallas kernel: it is the counterpart of XLA's
// Precision.HIGH dot, which the JAX package's SGPR core gives its chunked
// accumulation products when its precision variable names "high"
// (gpsat_tpu/ops/precision.py, gpsat_tpu/models/sgpr.py:126-146). On the TPU
// HIGH is a 3-pass bf16 split with f32-like error. Here each f32 operand x
// is split into hi = tf32(x) and lo = tf32(x - hi), tf32 rounding as
// cvt.rna.tf32.f32 does (to nearest, ties away from zero, 10 mantissa bits,
// the low 13 bits zero; done on the bits so that the plain version repeats
// it exactly), and the product is lo*hi + hi*lo + hi*hi, accumulated in f32
// on the tensor cores (nvcuda::wmma, precision::tf32, 16x16x8). The dropped
// lo*lo term and the rounding of lo leave about 3 * 2^-22 of |a||b| per
// product, against plain TF32's 2^-11. The precision is decided here, in the
// kernel: nothing touches PyTorch's process-wide TF32 switch.
//
// What bounds it on an H100: at the SGPR chunk's [8, 500, 500] x [8, 500,
// 4096] it moves 8 + 65.5 + 65.5 MB (about 0.04 ms at 3.35 TB/s) and issues
// 3 x 16.4 GFLOP on the TF32 tensor cores (about 0.10 ms at 495 TFLOP/s):
// operations bound it. The true-f32 product (torch.matmul with TF32 off)
// runs on the SIMT units, 0.245 ms at 67 TFLOP/s at best.
//
// Design (a first, simple kernel): one 128-thread block per 64x64 tile of C,
// four warps of 32x32 (2x2 wmma fragments each); K in steps of 32 staged in
// shared memory, each operand in its own global layout (a transposed operand
// becomes a col_major fragment), so the global reads are coalesced and the
// shared stores unit-stride; the 64x64 result goes through shared memory to
// a bounds-checked store, so M, N and K need not be multiples of anything
// (the SGPR's M = 500). Each fragment is split once after its load and
// serves two products. The tensor cores sum one K step of 32 (12 products
// a fragment) from zero, and the threads add that to the running sum in
// f32: with the whole sum kept in the tensor-core accumulator the first
// version lost 2.3e-6 to 7.0e-6 of |A||B| at K = 500 and 4,096 on an H100,
// 8 to 25 times torch.matmul's f32 error (its accumulation rounds more
// coarsely than an f32 add). No cp.async, no double buffering, no wgmma or
// TMA: later work.
//
// Shared memory (static): the two operand tiles, 2 x 2,304 floats (a 64 x
// 32 tile with rows padded to 36, or a 32 x 64 one with rows padded to 68),
// reused for the 64 x 68 output tile: 18,432 B.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmm3xtf32.so mm3xtf32.cu

#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;     // block tile of C, K step
constexpr int WM = 32, WN = 32;              // warp tile
constexpr int FM = 16, FN = 16, FK = 8;      // wmma tf32 fragment shape
constexpr int THREADS = 128;
constexpr int PAD = 4;
constexpr int LD_MK = BK + PAD;              // a tile stored [64][36]: rows along M (or N), K contiguous
constexpr int LD_KM = BM + PAD;              // a tile stored [32][68]: rows along K, M (or N) contiguous
constexpr int TILE_FLOATS = BM * LD_MK;      // 2,304 >= BK * LD_KM = 2,176
constexpr int LDC = BN + PAD;                // the output tile [64][68]

static_assert(BK * LD_KM <= TILE_FLOATS, "both tile layouts fit one buffer");
static_assert(BM * LDC <= 2 * TILE_FLOATS, "the output tile fits the two operand buffers");
static_assert(THREADS == (BM / WM) * (BN / WN) * 32, "one warp per 32x32 warp tile");

// cvt.rna.tf32.f32 on the bits: round to nearest, ties away from zero, to
// 10 mantissa bits; infinities and NaN pass through
__device__ __forceinline__ float tf32_rna(float x) {
    const unsigned u = __float_as_uint(x);
    if ((u & 0x7f800000u) == 0x7f800000u) return x;
    return __uint_as_float((u + 0x1000u) & 0xffffe000u);
}

// One operand's 64 x 32 (rows x K) tile into shared memory, zero outside the
// matrix. kRowsContiguous: the operand's rows (M for A, N for B) are its
// contiguous global dimension (a transposed A, an untransposed B), stored
// [K][rows] with stride LD_KM; else K is contiguous, stored [rows][K] with
// stride LD_MK. Consecutive threads take consecutive addresses of the
// contiguous dimension.
// A thread keeps one position of the contiguous dimension and walks the
// other one (a running pointer, so the loads hold few address registers).
template <bool kRowsContiguous>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g, long long ld, int rows, int K,
                                          int r0, int k0) {
    constexpr int kWidth = kRowsContiguous ? BM : BK;    // the contiguous dimension's extent in the tile
    constexpr int kStep = THREADS / kWidth;              // rows of the other dimension per pass
    const int c = threadIdx.x % kWidth, o = threadIdx.x / kWidth;
    const int gc = (kRowsContiguous ? r0 : k0) + c;
    const bool c_in = gc < (kRowsContiguous ? rows : K);
    int go = (kRowsContiguous ? k0 : r0) + o;
    const int o_end = kRowsContiguous ? K : rows;
    const float* p = g + static_cast<long long>(go) * ld + gc;
    float* d = s + (kRowsContiguous ? o * LD_KM + c : o * LD_MK + c);
#pragma unroll 4
    for (int i = 0; i < BM * BK / THREADS; ++i) {
        *d = (c_in && go < o_end) ? *p : 0.0f;
        go += kStep;
        p += kStep * ld;
        d += kStep * (kRowsContiguous ? LD_KM : LD_MK);
    }
}

template <class Frag>
__device__ __forceinline__ void split(Frag& hi, Frag& lo) {
#pragma unroll
    for (int e = 0; e < hi.num_elements; ++e) {
        const float x = hi.x[e];
        const float h = tf32_rna(x);
        hi.x[e] = h;
        lo.x[e] = tf32_rna(x - h);
    }
}

// kTA: op(A) = A^T (A stored [K][M], leading dimension lda), else A [M][K];
// kTB: op(B) = B^T (B stored [N][K]), else B [K][N]. C [batch][M][N]
// contiguous. Block t of the 1-d grid takes batch t / tiles, tile t % tiles.
template <bool kTA, bool kTB>
__global__ void __launch_bounds__(THREADS) mm3xtf32_kernel(
    const float* __restrict__ A, long long lda, long long strideA,
    const float* __restrict__ B, long long ldb, long long strideB,
    float* __restrict__ C, int M, int N, int K, int tiles_n, int tiles) {
    using LayoutA = typename std::conditional<kTA, wmma::col_major, wmma::row_major>::type;
    using LayoutB = typename std::conditional<kTB, wmma::col_major, wmma::row_major>::type;
    __shared__ __align__(32) float smem[2 * TILE_FLOATS];
    float* sA = smem;
    float* sB = smem + TILE_FLOATS;

    const int b = blockIdx.x / tiles;
    const int t = blockIdx.x % tiles;
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    A += b * strideA;
    B += b * strideB;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;

    // acc: the running sum, added to in f32 (round to nearest) by the
    // threads; part: one K step's 12 products on the tensor cores, from 0,
    // so that their accumulation (which rounds more coarsely than an f32
    // add) never holds a long running sum
    wmma::fragment<wmma::accumulator, FM, FN, FK, float> acc[2][2], part[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < K; k0 += BK) {
        load_tile<kTA>(sA, A, lda, M, K, m0, k0);
        load_tile<!kTB>(sB, B, ldb, N, K, n0, k0);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.0f);
#pragma unroll
        for (int kk = 0; kk < BK; kk += FK) {
            wmma::fragment<wmma::matrix_a, FM, FN, FK, wmma::precision::tf32, LayoutA> a_hi[2], a_lo[2];
            wmma::fragment<wmma::matrix_b, FM, FN, FK, wmma::precision::tf32, LayoutB> b_hi[2], b_lo[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int m = wm + i * FM;
                if (kTA) wmma::load_matrix_sync(a_hi[i], sA + kk * LD_KM + m, LD_KM);
                else wmma::load_matrix_sync(a_hi[i], sA + m * LD_MK + kk, LD_MK);
                split(a_hi[i], a_lo[i]);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int n = wn + j * FN;
                if (kTB) wmma::load_matrix_sync(b_hi[j], sB + n * LD_MK + kk, LD_MK);
                else wmma::load_matrix_sync(b_hi[j], sB + kk * LD_KM + n, LD_KM);
                split(b_hi[j], b_lo[j]);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    // the small terms first
                    wmma::mma_sync(part[i][j], a_lo[i], b_hi[j], part[i][j]);
                    wmma::mma_sync(part[i][j], a_hi[i], b_lo[j], part[i][j]);
                    wmma::mma_sync(part[i][j], a_hi[i], b_hi[j], part[i][j]);
                }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < acc[i][j].num_elements; ++e) acc[i][j].x[e] += part[i][j].x[e];
        __syncthreads();
    }

    float* sC = smem;  // the operand tiles are dead after the last barrier
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(sC + (wm + i * FM) * LDC + wn + j * FN, acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    C += static_cast<long long>(b) * M * N;
#pragma unroll 4
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        if (m0 + r < M && n0 + c < N) C[static_cast<long long>(m0 + r) * N + n0 + c] = sC[r * LDC + c];
    }
}

template <bool kTA, bool kTB>
cudaError_t launch_mm(const float* A, long long lda, long long strideA, const float* B, long long ldb,
                      long long strideB, float* C, int batch, int M, int N, int K, int tiles_n, int tiles,
                      cudaStream_t stream) {
    const int grid = batch * tiles;
    mm3xtf32_kernel<kTA, kTB><<<grid, THREADS, 0, stream>>>(A, lda, strideA, B, ldb, strideB, C, M, N, K,
                                                            tiles_n, tiles);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// C[b] = op(A[b]) op(B[b]) for b < batch, op(A) M x K, op(B) K x N, all f32
// device pointers. A is [M][K] (transA = 0) or [K][M] (transA = 1) with
// leading dimension lda and batch stride strideA; B is [K][N] (transB = 0)
// or [N][K] (transB = 1), likewise. C is [batch][M][N]
// contiguous. stream: a cudaStream_t. Returns the cudaError_t of the launch
// (0 on success); an empty product launches nothing.
int gpsat_mm3xtf32_f32(const void* A, long long lda, long long strideA, int transA, const void* B, long long ldb,
                       long long strideB, int transB, void* C, int batch, int M, int N, int K, void* stream) {
    if (batch <= 0 || M <= 0 || N <= 0) return 0;
    const int tiles_n = (N + BN - 1) / BN;
    const long long tiles = static_cast<long long>((M + BM - 1) / BM) * tiles_n;
    if (tiles * batch > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const auto* a = static_cast<const float*>(A);
    const auto* b = static_cast<const float*>(B);
    auto* c = static_cast<float*>(C);
    auto s = static_cast<cudaStream_t>(stream);
    const int t = static_cast<int>(tiles);
    cudaError_t err;
    if (transA) {
        err = transB ? launch_mm<true, true>(a, lda, strideA, b, ldb, strideB, c, batch, M, N, K, tiles_n, t, s)
                     : launch_mm<true, false>(a, lda, strideA, b, ldb, strideB, c, batch, M, N, K, tiles_n, t, s);
    } else {
        err = transB ? launch_mm<false, true>(a, lda, strideA, b, ldb, strideB, c, batch, M, N, K, tiles_n, t, s)
                     : launch_mm<false, false>(a, lda, strideA, b, ldb, strideB, c, batch, M, N, K, tiles_n, t, s);
    }
    return static_cast<int>(err);
}

}  // extern "C"
