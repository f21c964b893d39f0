// Cholesky factor and its inverse of 128x128 SPD blocks: L = chol(K),
// Linv = L^-1, one launch for a whole stack of blocks.
//
// Replaces the Pallas TPU kernel gpsat_tpu/ops/pallas/panel_chol.py
// (_panel_kernel, called through factor_panels). Same contract: the pivot is
// sqrt(max(a_kk, 1e-30)) and the column is scaled by its reciprocal, so a
// zero pivot gives finite values (an all-zero block gives L = 1e-15 I,
// Linv = 1e15 I); an identity block comes back exactly; the strict upper
// triangles of L and Linv are zero on output. The TPU kernel's stacked 2-d
// layout and indicator matmuls are not carried over: here every block is a
// matrix of its own, factored by one thread block.
//
// What bounds it on an H100: at the panel route's [512, 128, 128] f32 it
// reads K and writes L and Linv, 3 * 512 * 64 KB = 100.7 MB, 0.030 ms at
// 3.35 TB/s; its 2/3 * 128^3 flops per block are 0.011 ms at the f32 peak.
// What held the first, unblocked design back was neither: 128 dependent
// steps with two block barriers each, a rank-1 update one column at a time,
// and a serial dot product per step for the inverse's row.
//
// Design: the blocked 128-factor of factor128.cuh with the clamped pivot
// (kClamp = true): four 32-column panels, the 32x32 diagonal factor and its
// inverse in one warp, 4x4 register-tiled true-f32 FFMA products for the
// panels, the trailing blocks and the inverse's off-diagonal blocks; 16
// block barriers (384 in the unblocked design). This file adds the global
// side: K is read (lower blocks only) and L and Linv are written as float4,
// the upper blocks and triangles written as zeros.
//
// Shared memory 114,176 B (factor128.cuh), so two blocks fit on an SM and
// 512 matrices take two waves on 132 SMs. __launch_bounds__(256, 2) caps the
// registers at 128; nvcc -Xptxas -v for sm_90a reports 128 registers and no
// spills, and the occupancy query (gpsat_panel128_blocks_per_sm) two blocks
// per SM on an H100.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpanel_chol.so panel_chol.cu

#include <cuda_runtime.h>

#include "factor128.cuh"

namespace {

using namespace gpsat::f128;

constexpr int MAX_DEVICES = 64;

__global__ void __launch_bounds__(THREADS, 2)
panel128_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ Linv) {
    extern __shared__ __align__(16) float smem[];
    float* A = smem;                 // K's lower blocks; becomes L, then M below the diagonal
    float* W = smem + A_FLOATS;      // the ten lower tiles of Linv
    float* buf = W + W_FLOATS;       // the diagonal step's broadcast buffers

    const int tid = threadIdx.x;
    const size_t base = static_cast<size_t>(blockIdx.x) * T * T;
    constexpr int ROW4 = T / 4;      // float4 per row

    // K's lower 32x32 blocks into A (the upper ones are never read)
    const float4* K4 = reinterpret_cast<const float4*>(K + base);
#pragma unroll 8
    for (int e = tid; e < T * ROW4; e += THREADS) {
        const int r = e / ROW4, c = (e % ROW4) * 4;
        if (c / NB <= r / NB) st4(A + r * LDA + c, __ldg(K4 + e));
    }
    __syncthreads();

    factor</*kClamp=*/true>(A, W, buf);

    // L out (the diagonal blocks hold zeros above the diagonal already)
    float4* L4 = reinterpret_cast<float4*>(L + base);
#pragma unroll 4
    for (int e = tid; e < T * ROW4; e += THREADS) {
        const int r = e / ROW4, c = (e % ROW4) * 4;
        L4[e] = c / NB <= r / NB ? ld4(A + r * LDA + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }

    invert(A, W);

    float4* W4 = reinterpret_cast<float4*>(Linv + base);
#pragma unroll 4
    for (int e = tid; e < T * ROW4; e += THREADS) {
        const int r = e / ROW4, c = (e % ROW4) * 4;
        const int I = r / NB, J = c / NB;
        W4[e] = J <= I ? ld4(wtile(W, I, J) + (r % NB) * LDW + c % NB) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

bool configured[MAX_DEVICES];  // the shared-memory opt-in, set once per device

cudaError_t configure() {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && configured[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(panel128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
    if (err == cudaSuccess && dev < MAX_DEVICES) configured[dev] = true;
    return err;
}

}  // namespace

extern "C" {

// K, L, Linv: device pointers to [batch, 128, 128] contiguous f32; stream: a
// cudaStream_t. Returns the cudaError_t of the set-up or the launch (0 on
// success).
int gpsat_panel128_f32(const void* K, void* L, void* Linv, int batch, void* stream) {
    if (batch <= 0) return 0;
    cudaError_t err = configure();
    if (err != cudaSuccess) return static_cast<int>(err);
    panel128_kernel<<<batch, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(K), static_cast<float*>(L), static_cast<float*>(Linv));
    return static_cast<int>(cudaGetLastError());
}

// How many blocks of the kernel the current device holds on one SM at once.
int gpsat_panel128_blocks_per_sm(int* blocks) {
    cudaError_t err = configure();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, panel128_kernel, THREADS,
                                                                          SMEM_BYTES));
}

}  // extern "C"
