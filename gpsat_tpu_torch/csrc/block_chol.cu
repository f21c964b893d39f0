// Fused Cholesky + inverse of 64x64 SPD blocks: L = chol(K), W = L^-1.
//
// Replaces the Pallas TPU kernel gpsat_tpu/ops/pallas/block_chol.py
// (_cholinv_kernel, called through factor_blocks). Same contract: a
// non-positive pivot gives NaN (rsqrtf), which propagates into that
// matrix's L and W with no clamping, and the matrices beside it stay finite;
// strict upper triangles are zero on output; an identity comes back exactly;
// true f32 throughout (FFMA, no TF32).
//
// What bounds it on an H100: at the main path's [512, 64, 64] f32 it reads
// K and writes L and W, 3 * 512 * 16 KB = 25 MB, about 7.5 us at 3.35 TB/s;
// its ~2/3 * 64^3 flops per block are smaller still. So the bound is memory.
// All 512 matrices run in one wave, so the time is one matrix's latency.
// The first design (one 256-thread block per matrix, 64 right-looking steps
// with three block barriers each, row j of W as a serial dot product of
// length j) spent ~2 us on each of its 64 steps and ran at ~1/20 of the
// bound.
//
// Design: 2x2 blocks of 32, one 64-thread block (two warps) per matrix.
//  1. warp 0 factors and inverts the diagonal block (0,0) in one sweep: the
//     one-warp 32x32 step of factor128.cuh (a row per lane in registers, a
//     shuffle per pivot, one __syncwarp per step) with its rsqrt pivot
//     (kClamp = false: the column scaled by r = rsqrt(a_jj), row j of W by
//     __frcp_rn(a_jj * r));
//  2. L10 = A10 W00^T;
//  3. A11 -= L10 L10^T;
//  4. warp 0 factors and inverts (1,1);
//  5. M = W11 L10;
//  6. W10 = -M W00.
// Steps 2, 3, 5 and 6 are factor128.cuh's 4x4 register-tiled true-f32 FFMA
// products, 64 threads to a 32x32 block. A warp owns whole rows of each
// output, so steps 2, 5 and 6 work in place after a __syncwarp. There is no
// rank-1 loop and no serial dot product, and 6 block barriers (192 before),
// each spanning the one matrix. K is read and L and W written as float4:
// 64-float rows are 256-byte aligned.
//
// Shared memory (static): A 64 x 68 floats (consecutive rows 4 banks apart,
// as in factor128.cuh) 17,408 B; the tiles W00, W11 and W10 (32 x 36 floats
// each) 13,824 B; the diagonal step's buffers 512 B: 31,744 B, so seven
// blocks fit on an SM (7 x (31,744 + 1,024 reserved) <= 233,472 B) and 512
// matrices run in one wave on 132 SMs. __launch_bounds__(64, 7) keeps the
// registers to what seven blocks allow.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libblock_chol.so block_chol.cu

#include <cuda_runtime.h>

#include "factor128.cuh"

namespace {

namespace f128 = gpsat::f128;
using f128::ld4;
using f128::st4;

constexpr int T = 64;                        // block side
constexpr int NB = f128::NB;                 // 32: the diagonal step's side
constexpr int LDA = T + 4;                   // A's row stride
constexpr int LDW = f128::LDW;               // a W tile's row stride (36)
constexpr int THREADS = f128::GROUP;         // 64: one 32x32 output block, a 4x4 tile a thread
constexpr int BLOCKS_PER_SM = 7;
constexpr int ROW4 = T / 4;                  // float4 per row
constexpr int A_FLOATS = T * LDA;
constexpr int TILE_FLOATS = f128::TILE_FLOATS;
constexpr int SMEM_FLOATS = A_FLOATS + 3 * TILE_FLOATS + f128::BUF_FLOATS;
constexpr int MAX_DEVICES = 64;

static_assert(SMEM_FLOATS * sizeof(float) == 31744, "seven blocks per SM need at most 32,329 bytes each");
static_assert(THREADS == 64 && NB == 32, "two warps, each owning whole rows of a 32x32 output block");

// acc into rows r0 + 8q, columns c0 + 8p of X (tile_abt's layout)
__device__ __forceinline__ void store_abt(float* X, int ldx, const float (&acc)[4][4], int r0, int c0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) X[(r0 + 8 * q) * ldx + c0 + 8 * p] = acc[q][p];
}

// acc into rows r0 + 8q, columns 4 c0 .. 4 c0 + 3 of X (tile_ab's layout)
__device__ __forceinline__ void store_ab(float* X, int ldx, const float (&acc)[4][4], int r0, int c0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
        st4(X + (r0 + 8 * q) * ldx + 4 * c0, make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]));
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
cholinv64_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ W) {
    __shared__ __align__(16) float smem[SMEM_FLOATS];
    float* A = smem;                         // K's lower blocks; becomes L
    float* A10 = A + NB * LDA;
    float* A11 = A10 + NB;
    float* W00 = smem + A_FLOATS;
    float* W11 = W00 + TILE_FLOATS;
    float* W10 = W11 + TILE_FLOATS;          // first M = W11 L10, then W10
    float* buf = W10 + TILE_FLOATS;          // the diagonal step's broadcast buffers

    const int tid = threadIdx.x;
    const int r0 = tid / 8, c0 = tid % 8;    // a thread's 4x4 tile; warp w owns rows with r0 / 4 == w
    const size_t base = static_cast<size_t>(blockIdx.x) * T * T;
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    // K's blocks (0,0), (1,0) and (1,1) into A; (0,1) is never read
    const float4* K4 = reinterpret_cast<const float4*>(K + base);
#pragma unroll
    for (int u = 0; u < T * ROW4 / THREADS; ++u) {
        const int e = tid + u * THREADS, r = e / ROW4, c = (e % ROW4) * 4;
        if (c / NB <= r / NB) st4(A + r * LDA + c, __ldg(K4 + e));
    }
    __syncthreads();

    // 1. L00 and W00 (warp 1 waits at the barrier; only warp 0 touches buf)
    if (tid < 32) f128::diag_factor_inverse</*kClamp=*/false, LDA, LDW>(A, W00, buf, tid);
    __syncthreads();

    float acc[4][4];
    // 2. L10 = A10 W00^T, in place: a warp reads and writes its own rows only
    f128::zero_tile(acc);
    f128::tile_abt<false>(acc, A10, LDA, W00, LDW, r0, c0);
    __syncwarp();
    store_abt(A10, LDA, acc, r0, c0);
    __syncthreads();

    // 3. A11 -= L10 L10^T (the whole block; its upper triangle is never read)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = A11[(r0 + 8 * q) * LDA + c0 + 8 * p];
    f128::tile_abt<true>(acc, A10, LDA, A10, LDA, r0, c0);
    store_abt(A11, LDA, acc, r0, c0);
    __syncthreads();

    // 4. L11 and W11
    if (tid < 32) f128::diag_factor_inverse</*kClamp=*/false, LDA, LDW>(A11, W11, buf, tid);
    __syncthreads();

    // L out: A holds L00, L10 and L11, with zeros above the diagonal in the
    // diagonal blocks; the block (0,1) is written as zeros
    float4* L4 = reinterpret_cast<float4*>(L + base);
#pragma unroll
    for (int u = 0; u < T * ROW4 / THREADS; ++u) {
        const int e = tid + u * THREADS, r = e / ROW4, c = (e % ROW4) * 4;
        L4[e] = c / NB <= r / NB ? ld4(A + r * LDA + c) : zero4;
    }

    // 5. M = W11 L10 into W10's tile, rows the warp reads again in step 6
    f128::zero_tile(acc);
    f128::tile_ab<false>(acc, W11, LDW, A10, LDA, r0, c0);
    store_ab(W10, LDW, acc, r0, c0);
    __syncwarp();
    // 6. W10 = -M W00, in place
    f128::zero_tile(acc);
    f128::tile_ab<true>(acc, W10, LDW, W00, LDW, r0, c0);
    __syncwarp();
    store_ab(W10, LDW, acc, r0, c0);
    __syncthreads();

    float4* W4 = reinterpret_cast<float4*>(W + base);
#pragma unroll
    for (int u = 0; u < T * ROW4 / THREADS; ++u) {
        const int e = tid + u * THREADS, r = e / ROW4, c = (e % ROW4) * 4;
        const int I = r / NB, J = c / NB;
        const float* tile = I == 0 ? W00 : (J == 0 ? W10 : W11);
        W4[e] = J <= I ? ld4(tile + (r % NB) * LDW + c % NB) : zero4;
    }
}

bool configured[MAX_DEVICES];  // the shared-memory carveout, set once per device

cudaError_t configure() {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && configured[dev]) return cudaSuccess;
    // ask for the largest shared-memory carveout, so seven blocks fit on an SM
    err = cudaFuncSetAttribute(cholinv64_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err == cudaSuccess && dev < MAX_DEVICES) configured[dev] = true;
    return err;
}

}  // namespace

extern "C" {

// K, L, W: device pointers to [batch, 64, 64] contiguous f32, 16-byte
// aligned; stream: a cudaStream_t. Returns the cudaError_t of the set-up or
// the launch (0 on success).
int gpsat_cholinv64_f32(const void* K, void* L, void* W, int batch, void* stream) {
    if (batch <= 0) return 0;
    cudaError_t err = configure();
    if (err != cudaSuccess) return static_cast<int>(err);
    cholinv64_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(K), static_cast<float*>(L), static_cast<float*>(W));
    return static_cast<int>(cudaGetLastError());
}

// How many blocks of the kernel the current device holds on one SM at once.
int gpsat_cholinv64_blocks_per_sm(int* blocks) {
    cudaError_t err = configure();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cholinv64_kernel, THREADS, 0));
}

}  // extern "C"
