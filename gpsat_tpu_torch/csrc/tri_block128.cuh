// Unblocked Cholesky (and, if asked, the inverse of the factor) of one
// 128x128 f32 block held in shared memory, by one thread block.
//
// Shared by panel_chol.cu (the 128-block factor pair) and cholesky.cu (the
// diagonal step of the full blocked Cholesky). The two callers differ only in
// the pivot rule, chosen by kClamp so that each keeps the contract of the
// TPU kernel it replaces:
//
//   kClamp = true   d = sqrt(max(a_jj, 1e-30)), column scaled by 1/d, row j
//                   of the inverse scaled by 1/d: a zero pivot stays finite
//   kClamp = false  r = rsqrt(a_jj), L_jj = a_jj * r, column scaled by r, row
//                   j of the inverse divided by L_jj: a non-positive pivot
//                   gives NaN, which spreads through the block
//
// Step j of 128: read the pivot; scale column j; then, between one pair of
// barriers, the rank-1 update of the trailing lower triangle (all warps: a
// warp takes a row, its lanes the columns up to the diagonal) and row j of
// the inverse by forward substitution (the last 128 threads, one column
// each). Only the lower triangle of A is ever read or written, so the caller
// may leave anything above the diagonal.

#pragma once

#include <cuda_runtime.h>

namespace gpsat {

constexpr int T128 = 128;        // block side
constexpr int LD128 = T128 + 1;  // padded row stride: column walks hit distinct banks
constexpr size_t BLOCK128_BYTES = static_cast<size_t>(T128) * LD128 * sizeof(float);

// A:  [128][129] the SPD block (lower triangle), overwritten by L
// Wi: [128][129] zero on entry; rows of L^-1 on exit (untouched without kInverse)
// All THREADS threads of the block must call this (it synchronises).
template <bool kClamp, bool kInverse, int THREADS>
__device__ __forceinline__ void factor_block128(float* A, float* Wi) {
    static_assert(THREADS >= T128 && THREADS % 32 == 0, "need at least one thread per row");
    constexpr int T = T128, LD = LD128, WARPS = THREADS / 32;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int wt = tid - (THREADS - T);  // column of the inverse this thread owns, if >= 0

    for (int j = 0; j < T; ++j) {
        // every thread reads a_jj before anyone rescales column j
        const float ajj = A[j * LD + j];
        __syncthreads();
        float ljj, colscale, wscale;
        if constexpr (kClamp) {
            ljj = sqrtf(ajj < 1e-30f ? 1e-30f : ajj);  // a NaN pivot stays NaN
            colscale = 1.0f / ljj;
            wscale = colscale;
        } else {
            colscale = rsqrtf(ajj);  // NaN for a_jj < 0, inf for 0
            ljj = ajj * colscale;
            wscale = 1.0f / ljj;
        }
        if (tid > j && tid < T) A[tid * LD + j] *= colscale;
        if (tid == j) A[j * LD + j] = ljj;
        __syncthreads();

        // rank-1 update of the trailing lower triangle
        for (int r = j + 1 + warp; r < T; r += WARPS) {
            const float lr = A[r * LD + j];
            for (int c = j + 1 + lane; c <= r; c += 32) A[r * LD + c] -= lr * A[c * LD + j];
        }
        // row j of the inverse: (e_j - L[j, :j] W[:j, :]) / L_jj. Reads
        // L[j, :j] and rows < j of W, which this step does not write; W[k, c]
        // is zero for k < c, so the sum starts at k = c.
        if constexpr (kInverse) {
            if (wt >= 0 && wt <= j) {
                float acc = 0.0f;
                for (int k = wt; k < j; ++k) acc += A[j * LD + k] * Wi[k * LD + wt];
                Wi[j * LD + wt] = ((wt == j ? 1.0f : 0.0f) - acc) * wscale;
            }
        }
        __syncthreads();
    }
}

}  // namespace gpsat
