// Cholesky factor and its inverse of 128x128 SPD blocks: L = chol(K),
// Linv = L^-1, one launch for a whole stack of blocks.
//
// Replaces the Pallas TPU kernel gpsat_tpu/ops/pallas/panel_chol.py
// (_panel_kernel, called through factor_panels). Same contract: one
// right-looking 128-step loop emits column k of L and row k of the inverse
// together; the pivot is sqrt(max(a_kk, 1e-30)) and the column is scaled by
// 1/pivot, so a zero pivot gives finite values (no NaN from a zero block);
// the strict upper triangle of L is zero on output. The TPU kernel's stacked
// 2-d layout and indicator matmuls are not carried over: here every block is
// a matrix of its own.
//
// What bounds it on an H100: at the panel route's [512, 128, 128] f32 it
// reads K and writes L and Linv, 3 * 512 * 64 KB = 100.7 MB, 0.030 ms at
// 3.35 TB/s; its 2/3 * 128^3 flops per block are 0.011 ms at the f32 peak.
// So the bound is memory, but the 128 dependent steps (three barriers each)
// make it latency-bound in practice.
//
// Design (simple and right first): one thread block of 512 threads per
// matrix. The trailing matrix and the inverse both sit in shared memory, rows
// padded to 129 floats: 2 * 128 * 129 * 4 = 132,096 bytes, above the 48 KB
// static limit, so it is dynamic shared memory opted into with
// cudaFuncSetAttribute, and one block fits on an SM at a time (512 blocks
// run in about four waves on 132 SMs). Keeping only the triangles, several
// matrices per SM and warp-level pivots are left for a later change.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpanel_chol.so panel_chol.cu

#include <cuda_runtime.h>

#include "tri_block128.cuh"

namespace {

using gpsat::LD128;
using gpsat::T128;

constexpr int THREADS = 512;
constexpr size_t SMEM_BYTES = 2 * gpsat::BLOCK128_BYTES;

__global__ void __launch_bounds__(THREADS)
panel128_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ Linv) {
    extern __shared__ float smem[];
    float* A = smem;                   // trailing matrix; becomes L in its lower triangle
    float* Wi = smem + T128 * LD128;   // rows of L^-1, one per step

    const int tid = threadIdx.x;
    const size_t base = static_cast<size_t>(blockIdx.x) * T128 * T128;

    for (int e = tid; e < T128 * T128; e += THREADS) {
        const int r = e / T128, c = e % T128;
        A[r * LD128 + c] = K[base + e];
        Wi[r * LD128 + c] = 0.0f;
    }
    __syncthreads();

    gpsat::factor_block128</*kClamp=*/true, /*kInverse=*/true, THREADS>(A, Wi);

    for (int e = tid; e < T128 * T128; e += THREADS) {
        const int r = e / T128, c = e % T128;
        const bool lower = r >= c;
        L[base + e] = lower ? A[r * LD128 + c] : 0.0f;
        Linv[base + e] = lower ? Wi[r * LD128 + c] : 0.0f;
    }
}

}  // namespace

extern "C" {

// K, L, Linv: device pointers to [batch, 128, 128] contiguous f32; stream: a
// cudaStream_t. Returns the cudaError_t of the set-up or the launch (0 on
// success).
int gpsat_panel128_f32(const void* K, void* L, void* Linv, int batch, void* stream) {
    if (batch <= 0) return 0;
    cudaError_t err = cudaFuncSetAttribute(
        panel128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    panel128_kernel<<<batch, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(K), static_cast<float*>(L), static_cast<float*>(Linv));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
