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
// Design: blocked, panel width 32, four outer steps, 256 threads.
//  1. Diagonal step: warp 0 factors the 32x32 diagonal block and inverts it
//     in one sweep, with no block barrier. Lane i holds row i of the block
//     and row i of its inverse in registers (loops fully unrolled, so the
//     indices are static). At pivot j every lane reads a_jj by a shuffle and
//     computes the clamped pivot d and 1/d itself (sqrtf and __frcp_rn, both
//     correctly rounded, as the plain version's sqrt and 1/d are); column j
//     of L and row j of the inverse pass through a small double-buffered
//     shared buffer and one __syncwarp. The inverse is forward elimination:
//     row j is scaled by 1/d, then subtracted from the rows below.
//  2. Panel: L21 = A21 * W11^T, with W11 the diagonal block's inverse, all
//     warps; a warp owns whole rows of its 32x32 output block, so it writes
//     them in place after a __syncwarp.
//  3. Trailing update: A22 -= L21 * L21^T on the lower 32x32 blocks only,
//     each thread a 4x4 register tile in true f32 FFMA (no TF32 mma: it
//     keeps about three digits and would break the 2e-5 bound on Linv),
//     subtracting the 32 products in the order of the plain version's
//     rank-1 steps.
//  4. Inverse by blocks, after the factor: M_IK = W_II * L_IK for I > K,
//     then W_IJ = -sum_{K=J}^{I-1} M_IK * W_KJ by sub-diagonal
//     (d = I - J = 1, 2, 3), all blocks of one sub-diagonal at once.
// 16 block barriers in all (384 in the unblocked design). Operand reads are
// 16-byte shared loads; row strides of 132 and 36 floats put consecutive
// rows 4 banks apart, so the 8 rows a quarter-warp reads hit 8 distinct
// bank groups. K is read (lower blocks only) and L and Linv are written as
// float4, the upper blocks and triangles written as zeros.
//
// Shared memory: A (128 x 132 floats, K becoming L, then M) 67,584 B; the
// ten lower 32x32 tiles of Linv (32 x 36 floats each) 46,080 B; the
// diagonal step's buffers 512 B: 114,176 B, so two blocks fit on an SM
// (2 x (114,176 + 1,024 reserved) <= 233,472 B) and 512 matrices take two
// waves on 132 SMs. __launch_bounds__(256, 2) caps the registers at 128;
// nvcc -Xptxas -v for sm_90a reports 128 registers and no spills, and the
// occupancy query (gpsat_panel128_blocks_per_sm) two blocks per SM on an
// H100.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpanel_chol.so panel_chol.cu

#include <cuda_runtime.h>

namespace {

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
constexpr int MAX_DEVICES = 64;

static_assert(SMEM_BYTES == 114176, "two blocks per SM need at most 115,712 bytes each");
static_assert(NB == 32, "the diagonal step maps one row to one lane");

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

// Warp 0: factor the 32x32 diagonal block at Ad (row stride LDA) in place
// into L11 and write its inverse W11 to the tile Wd, both with zeros above
// the diagonal. buf: 4 * NB floats of scratch.
__device__ __forceinline__ void diag_factor_inverse(float* Ad, float* Wd, float* buf, int lane) {
    float a[NB], w[NB];
#pragma unroll
    for (int c = 0; c < NB; c += 4) {
        const float4 v = ld4(Ad + lane * LDA + c);
        a[c] = v.x, a[c + 1] = v.y, a[c + 2] = v.z, a[c + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) w[c] = c == lane ? 1.0f : 0.0f;

#pragma unroll
    for (int j = 0; j < NB; ++j) {
        const float ajj = __shfl_sync(FULL, a[j], j);
        const float d = sqrtf(ajj < PIVOT_FLOOR ? PIVOT_FLOOR : ajj);  // a NaN pivot stays NaN
        const float dinv = __frcp_rn(d);
        if (lane > j) {
            a[j] *= dinv;  // l_ij
        } else if (lane == j) {
            a[j] = d;
#pragma unroll
            for (int c = 0; c <= j; ++c) w[c] *= dinv;  // row j of W is final
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
        st4(Ad + lane * LDA + c, lv);
        st4(Wd + lane * LDW + c, wv);
    }
}

__global__ void __launch_bounds__(THREADS, 2)
panel128_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ Linv) {
    extern __shared__ __align__(16) float smem[];
    float* A = smem;                 // K's lower blocks; becomes L, then M below the diagonal
    float* W = smem + A_FLOATS;      // the ten lower tiles of Linv
    float* buf = W + W_FLOATS;       // the diagonal step's broadcast buffers

    const int tid = threadIdx.x;
    const int g = tid % GROUP, r0 = g / 8, c0 = g % 8;  // a thread's 4x4 tile in its 32x32 block
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

#pragma unroll 1
    for (int k = 0; k < NK; ++k) {
        const int o = k * NB;
        if (tid < 32) diag_factor_inverse(A + o * LDA + o, wtile(W, k, k), buf, tid);
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

    // L out (the diagonal blocks hold zeros above the diagonal already)
    float4* L4 = reinterpret_cast<float4*>(L + base);
#pragma unroll 4
    for (int e = tid; e < T * ROW4; e += THREADS) {
        const int r = e / ROW4, c = (e % ROW4) * 4;
        L4[e] = c / NB <= r / NB ? ld4(A + r * LDA + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }

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
