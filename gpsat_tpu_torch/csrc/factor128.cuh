// Blocked Cholesky factor, and the inverse of that factor, of one 128x128
// f32 SPD block held in shared memory, by one thread block of 256 threads.
//
// Shared by panel_chol.cu (kernel 2: L and L^-1 of stacked 128x128 blocks)
// and cholesky.cu (kernel 3: the diagonal step of the full blocked
// Cholesky); block_chol.cu (kernel 1, 64x64 blocks) takes only the one-warp
// 32x32 step, with the rsqrt pivot, and the tile products. Kernels 2 and 3
// differ only in the pivot rule, chosen by kClamp so that each keeps the
// contract of the TPU kernel it replaces:
//
//   kClamp = true   d = sqrtf(max(a_jj, 1e-30)), column and row j of the
//                   inverse scaled by __frcp_rn(d): a zero pivot stays finite
//   kClamp = false  r = rsqrtf(a_jj), L_jj = a_jj * r, column scaled by r,
//                   row j of the inverse by __frcp_rn(L_jj): a non-positive
//                   pivot gives NaN, which spreads through the block
//
// Design: panel width 32, four outer steps (factor()), then the inverse's
// off-diagonal blocks (invert()), which a caller that needs no inverse skips.
//  1. Diagonal step: warp 0 factors the 32x32 diagonal block and inverts it
//     in one sweep, with no block barrier. Lane i holds row i of the block
//     and row i of its inverse in registers (loops fully unrolled, so the
//     indices are static). At pivot j every lane reads a_jj by a shuffle and
//     computes the pivot and its scales itself; column j of L and row j of
//     the inverse pass through a small double-buffered shared buffer and one
//     __syncwarp. The inverse is forward elimination: row j is scaled, then
//     subtracted from the rows below.
//  2. Panel: L21 = A21 * W11^T, with W11 the diagonal block's inverse, all
//     warps; a warp owns whole rows of its 32x32 output block, so it writes
//     them in place after a __syncwarp.
//  3. Trailing update: A22 -= L21 * L21^T on the lower 32x32 blocks only,
//     each thread a 4x4 register tile in true f32 FFMA (no TF32 mma: it
//     keeps about three digits), subtracting the 32 products in the order of
//     the rank-1 steps.
//  4. Inverse by blocks, after the factor: M_IK = W_II * L_IK for I > K,
//     then W_IJ = -sum_{K=J}^{I-1} M_IK * W_KJ by sub-diagonal
//     (d = I - J = 1, 2, 3), all blocks of one sub-diagonal at once.
// 16 block barriers in all. Operand reads are 16-byte shared loads; row
// strides of 132 and 36 floats put consecutive rows 4 banks apart, so the 8
// rows a quarter-warp reads hit 8 distinct bank groups.
//
// Shared memory (the caller's, SMEM_BYTES): A (128 x 132 floats) 67,584 B;
// the ten lower 32x32 tiles of the inverse (32 x 36 floats each) 46,080 B;
// the diagonal step's buffers 512 B: 114,176 B, so two blocks fit on an SM
// (2 x (114,176 + 1,024 reserved) <= 233,472 B). A kernel built on this
// takes __launch_bounds__(THREADS, 2), which caps it at 128 registers.

#pragma once

#include <cuda_runtime.h>

namespace gpsat {
namespace f128 {

constexpr int T = 128;                       // block side
constexpr int NB = 32;                       // panel width
constexpr int NK = T / NB;                   // outer steps
constexpr int LDA = T + 4;                   // A's row stride
constexpr int LDW = NB + 4;                  // an inverse tile's row stride
constexpr int THREADS = 256;
constexpr int GROUP = 64;                    // threads per 32x32 output block (4x4 tiles each)
constexpr int A_FLOATS = T * LDA;
constexpr int TILE_FLOATS = NB * LDW;
constexpr int W_FLOATS = NK * (NK + 1) / 2 * TILE_FLOATS;
constexpr int BUF_FLOATS = 2 * 2 * NB;       // two buffers of (column of L, row of W)
constexpr size_t SMEM_BYTES = (A_FLOATS + W_FLOATS + BUF_FLOATS) * sizeof(float);
constexpr float PIVOT_FLOOR = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(SMEM_BYTES == 114176, "two blocks per SM need at most 115,712 bytes each");
static_assert(NB == 32, "the diagonal step maps one row to one lane");

// The lower tile (I, J), I >= J, of the inverse.
__device__ __forceinline__ float* wtile(float* W, int I, int J) { return W + (I * (I + 1) / 2 + J) * TILE_FLOATS; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// acc[q][p] (+/-)= sum_{k<NB} X[(r0+8q)*ldx + k] * Y[(c0+8p)*ldy + k]: a
// 4x4 tile of X * Y^T, both operands read along their rows.
template <bool kSub>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* X, int ldx, const float* Y, int ldy,
                                         int r0, int c0) {
#pragma unroll 2
    for (int k = 0; k < NB; k += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = ld4(X + (r0 + 8 * q) * ldx + k);
#pragma unroll
        for (int p = 0; p < 4; ++p) y[p] = ld4(Y + (c0 + 8 * p) * ldy + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float s = kSub ? -1.0f : 1.0f;
            const float xs[4] = {s * x[q].x, s * x[q].y, s * x[q].z, s * x[q].w};
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                acc[q][p] = fmaf(xs[0], y[p].x, acc[q][p]);
                acc[q][p] = fmaf(xs[1], y[p].y, acc[q][p]);
                acc[q][p] = fmaf(xs[2], y[p].z, acc[q][p]);
                acc[q][p] = fmaf(xs[3], y[p].w, acc[q][p]);
            }
        }
    }
}

// acc[q][p] (+/-)= sum_{k<NB} X[(r0+8q)*ldx + k] * Y[k*ldy + 4*c0 + p]: a
// 4x4 tile of X * Y, X read along rows and Y as float4 across its columns.
template <bool kSub>
__device__ __forceinline__ void tile_ab(float (&acc)[4][4], const float* X, int ldx, const float* Y, int ldy,
                                        int r0, int c0) {
#pragma unroll 2
    for (int k = 0; k < NB; k += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = ld4(X + (r0 + 8 * q) * ldx + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = ld4(Y + (k + j) * ldy + 4 * c0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float s = kSub ? -1.0f : 1.0f;
            const float xs[4] = {s * x[q].x, s * x[q].y, s * x[q].z, s * x[q].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[q][0] = fmaf(xs[j], y[j].x, acc[q][0]);
                acc[q][1] = fmaf(xs[j], y[j].y, acc[q][1]);
                acc[q][2] = fmaf(xs[j], y[j].z, acc[q][2]);
                acc[q][3] = fmaf(xs[j], y[j].w, acc[q][3]);
            }
        }
    }
}

__device__ __forceinline__ void zero_tile(float (&acc)[4][4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = 0.0f;
}

// Warp 0: factor the 32x32 diagonal block at Ad (row stride kLda) in place
// into L11 and write its inverse W11 to the tile Wd (row stride kLdw), both
// with zeros above the diagonal. buf: 4 * NB floats of scratch. Only the
// lower triangle of the block is read into any output. The strides default
// to this header's; block_chol.cu passes its own for a 64x64 block.
template <bool kClamp, int kLda = LDA, int kLdw = LDW>
__device__ __forceinline__ void diag_factor_inverse(float* Ad, float* Wd, float* buf, int lane) {
    float a[NB], w[NB];
#pragma unroll
    for (int c = 0; c < NB; c += 4) {
        const float4 v = ld4(Ad + lane * kLda + c);
        a[c] = v.x, a[c + 1] = v.y, a[c + 2] = v.z, a[c + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) w[c] = c == lane ? 1.0f : 0.0f;

#pragma unroll
    for (int j = 0; j < NB; ++j) {
        const float ajj = __shfl_sync(FULL, a[j], j);
        float d, dinv, wscale;
        if constexpr (kClamp) {
            d = sqrtf(ajj < PIVOT_FLOOR ? PIVOT_FLOOR : ajj);  // a NaN pivot stays NaN
            dinv = __frcp_rn(d);
            wscale = dinv;
        } else {
            dinv = rsqrtf(ajj);  // NaN for a_jj < 0, inf for 0 (then d = 0 * inf = NaN)
            d = ajj * dinv;
            wscale = __frcp_rn(d);
        }
        if (lane > j) {
            a[j] *= dinv;  // l_ij
        } else if (lane == j) {
            a[j] = d;
#pragma unroll
            for (int c = 0; c <= j; ++c) w[c] *= wscale;  // row j of W is final
        }
        float* col = buf + (j & 1) * 2 * NB;
        float* row = col + NB;
        col[lane] = a[j];
        if (lane == j) {
#pragma unroll
            for (int c = 0; c <= j; c += 4) st4(row + c, make_float4(w[c], w[c + 1], w[c + 2], w[c + 3]));
        }
        __syncwarp();
        // column j of L below the pivot updates the trailing part of every
        // row (the part above the diagonal of rows <= j is never read); row j
        // of W is subtracted from the rows of W below it
        float l[NB], wj[NB];
#pragma unroll
        for (int c = (j + 1) / 4 * 4; c < NB; c += 4) {
            const float4 v = ld4(col + c);
            l[c] = v.x, l[c + 1] = v.y, l[c + 2] = v.z, l[c + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c <= j; c += 4) {
            const float4 v = ld4(row + c);
            wj[c] = v.x, wj[c + 1] = v.y, wj[c + 2] = v.z, wj[c + 3] = v.w;
        }
        const float lij = a[j];
#pragma unroll
        for (int c = j + 1; c < NB; ++c) a[c] = fmaf(-lij, l[c], a[c]);
        if (lane > j) {
#pragma unroll
            for (int c = 0; c <= j; ++c) w[c] = fmaf(-lij, wj[c], w[c]);
        }
    }

#pragma unroll
    for (int c = 0; c < NB; c += 4) {
        float4 lv, wv;
        lv.x = c <= lane ? a[c] : 0.0f, wv.x = c <= lane ? w[c] : 0.0f;
        lv.y = c + 1 <= lane ? a[c + 1] : 0.0f, wv.y = c + 1 <= lane ? w[c + 1] : 0.0f;
        lv.z = c + 2 <= lane ? a[c + 2] : 0.0f, wv.z = c + 2 <= lane ? w[c + 2] : 0.0f;
        lv.w = c + 3 <= lane ? a[c + 3] : 0.0f, wv.w = c + 3 <= lane ? w[c + 3] : 0.0f;
        st4(Ad + lane * kLda + c, lv);
        st4(Wd + lane * kLdw + c, wv);
    }
}

// Steps 1-3, by all THREADS threads, on A (the block's lower 32x32 blocks,
// row stride LDA; the upper blocks are never read or written): A becomes L,
// with zeros above the diagonal inside its diagonal blocks, and the
// diagonal tiles of W the inverses of those blocks. Ends with a block
// barrier.
template <bool kClamp>
__device__ __forceinline__ void factor(float* A, float* W, float* buf) {
    const int tid = threadIdx.x;
    const int g = tid % GROUP, r0 = g / 8, c0 = g % 8;  // a thread's 4x4 tile in its 32x32 block

#pragma unroll 1
    for (int k = 0; k < NK; ++k) {
        const int o = k * NB;
        if (tid < 32) diag_factor_inverse<kClamp>(A + o * LDA + o, wtile(W, k, k), buf, tid);
        __syncthreads();
        if (k == NK - 1) break;

        // panel: L_Ik = A_Ik * W_kk^T for the row blocks I below, in place
        const int below = NK - 1 - k;
        if (tid < GROUP * below) {
            float* X = A + (o + NB + (tid / GROUP) * NB) * LDA + o;
            float acc[4][4];
            zero_tile(acc);
            tile_abt<false>(acc, X, LDA, wtile(W, k, k), LDW, r0, c0);
            __syncwarp();  // the warp owns its rows: all read before any is written
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int p = 0; p < 4; ++p) X[(r0 + 8 * q) * LDA + c0 + 8 * p] = acc[q][p];
        }
        __syncthreads();

        // trailing update of the lower blocks (I, J), k < J <= I
        for (int t = tid; t < GROUP * below * (below + 1) / 2; t += THREADS) {
            const int b = t / GROUP;
            const int i = b < 1 ? 0 : (b < 3 ? 1 : 2), j = b - i * (i + 1) / 2;
            const int I = k + 1 + i, J = k + 1 + j;
            float* C = A + I * NB * LDA + J * NB;
            float acc[4][4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int p = 0; p < 4; ++p) acc[q][p] = C[(r0 + 8 * q) * LDA + c0 + 8 * p];
            tile_abt<true>(acc, A + I * NB * LDA + o, LDA, A + J * NB * LDA + o, LDA, r0, c0);
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int p = 0; p < 4; ++p) C[(r0 + 8 * q) * LDA + c0 + 8 * p] = acc[q][p];
        }
        __syncthreads();
    }
}

// Step 4, by all THREADS threads, after factor() and after the caller has
// read what it needs of L out of A: the ten lower tiles of W become those of
// L^-1, and A's blocks below the diagonal are overwritten (by M). Ends with
// a block barrier.
__device__ __forceinline__ void invert(float* A, float* W) {
    const int tid = threadIdx.x;
    const int g = tid % GROUP, r0 = g / 8, c0 = g % 8;

    // M_IK = W_II * L_IK for the six blocks below the diagonal, in place of
    // L_IK: 384 tiles, so threads below 128 take two
    float acc2[2][4][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int b = tid / GROUP + s * (THREADS / GROUP);  // (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
        if (b < 6) {
            const int I = b < 1 ? 1 : (b < 3 ? 2 : 3), Kb = b - I * (I - 1) / 2;
            zero_tile(acc2[s]);
            tile_ab<false>(acc2[s], wtile(W, I, I), LDW, A + I * NB * LDA + Kb * NB, LDA, r0, c0);
        }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int b = tid / GROUP + s * (THREADS / GROUP);
        if (b < 6) {
            const int I = b < 1 ? 1 : (b < 3 ? 2 : 3), Kb = b - I * (I - 1) / 2;
            float* C = A + I * NB * LDA + Kb * NB;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                st4(C + (r0 + 8 * q) * LDA + 4 * c0,
                    make_float4(acc2[s][q][0], acc2[s][q][1], acc2[s][q][2], acc2[s][q][3]));
        }
    }
    __syncthreads();

    // W_IJ = -sum_{K=J}^{I-1} M_IK * W_KJ, one sub-diagonal d = I - J at a
    // time; a round reads only tiles of earlier rounds
#pragma unroll 1
    for (int d = 1; d < NK; ++d) {
        const int J = tid / GROUP, I = J + d;
        if (I < NK) {
            float acc[4][4];
            zero_tile(acc);
            for (int Kb = J; Kb < I; ++Kb)
                tile_ab<true>(acc, A + I * NB * LDA + Kb * NB, LDA, wtile(W, Kb, J), LDW, r0, c0);
            float* C = wtile(W, I, J);
#pragma unroll
            for (int q = 0; q < 4; ++q)
                st4(C + (r0 + 8 * q) * LDW + 4 * c0, make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]));
        }
        __syncthreads();
    }
}

}  // namespace f128
}  // namespace gpsat
