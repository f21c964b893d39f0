// Fused Cholesky + inverse of 64x64 SPD blocks: L = chol(K), W = L^-1.
//
// Replaces the Pallas TPU kernel gpsat_tpu/ops/pallas/block_chol.py
// (_cholinv_kernel, called through factor_blocks). Same contract: one
// right-looking 64-step loop emits column j of L and row j of W together;
// a non-positive pivot gives NaN (rsqrtf), which propagates into both
// outputs with no clamping; strict upper triangles are zero on output.
//
// What bounds it on an H100: at the main path's [512, 64, 64] f32 it reads
// K and writes L and W, 3 * 512 * 16 KB = 25 MB, about 7.5 us at 3.35 TB/s;
// its ~2/3 * 64^3 flops per block are smaller still. So the bound is memory,
// but in practice the 64 dependent steps (three barriers each) make it
// latency-bound.
//
// Design (simple and right first): one thread block of 256 threads per
// matrix. The trailing matrix and W sit in shared memory, rows padded to 65
// floats so column walks hit distinct banks (2 * 64 * 65 * 4 = 33,280 bytes
// static, under the 48 KB default). Up to six blocks share an SM, so the
// 512 matrices of the main path run in one wave on 132 SMs. Packing several
// matrices per block, warp-level pivots and cp.async loads are left for a
// later change.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libblock_chol.so block_chol.cu

#include <cuda_runtime.h>

namespace {

constexpr int T = 64;        // block side
constexpr int LD = T + 1;    // padded shared-memory row stride
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cholinv64_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ W) {
    __shared__ float A[T * LD];   // trailing matrix; becomes L in its lower triangle
    __shared__ float Wi[T * LD];  // rows of W = L^-1, filled one per step

    const int tid = threadIdx.x;
    const size_t base = static_cast<size_t>(blockIdx.x) * T * T;

    for (int e = tid; e < T * T; e += THREADS) {
        const int r = e / T, c = e % T;
        A[r * LD + c] = K[base + e];
        Wi[r * LD + c] = 0.0f;
    }
    __syncthreads();

    for (int j = 0; j < T; ++j) {
        // pivot: every thread reads a_jj before anyone rescales column j
        const float ajj = A[j * LD + j];
        __syncthreads();
        const float d = rsqrtf(ajj);  // 1 / L[j, j]; NaN for a_jj <= 0

        // column j of L
        if (tid >= j && tid < T) A[tid * LD + j] *= d;
        __syncthreads();

        // rank-1 update of the trailing lower triangle (columns > j)
        const int n = T - 1 - j;
        for (int e = tid; e < n * n; e += THREADS) {
            const int r = j + 1 + e / n, c = j + 1 + e % n;
            if (r >= c) A[r * LD + c] -= A[r * LD + j] * A[c * LD + j];
        }
        // row j of W by forward substitution: (e_j - L[j, :j] W[:j, :]) * d.
        // Reads only L[j, :j] and W rows < j, which this step does not write.
        if (tid < T) {
            float acc = 0.0f;
            for (int k = 0; k < j; ++k) acc += A[j * LD + k] * Wi[k * LD + tid];
            Wi[j * LD + tid] = ((tid == j ? 1.0f : 0.0f) - acc) * d;
        }
        __syncthreads();
    }

    for (int e = tid; e < T * T; e += THREADS) {
        const int r = e / T, c = e % T;
        const bool lower = r >= c;
        L[base + e] = lower ? A[r * LD + c] : 0.0f;
        W[base + e] = lower ? Wi[r * LD + c] : 0.0f;
    }
}

}  // namespace

extern "C" {

// K, L, W: device pointers to [batch, 64, 64] contiguous f32; stream: a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
int gpsat_cholinv64_f32(const void* K, void* L, void* W, int batch, void* stream) {
    if (batch <= 0) return 0;
    cholinv64_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(K), static_cast<float*>(L), static_cast<float*>(W));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
