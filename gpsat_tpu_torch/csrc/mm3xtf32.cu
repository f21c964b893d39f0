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
// it exactly), and the product is lo*hi + hi*lo + hi*hi on the tensor cores.
// The dropped lo*lo term and the rounding of lo leave about 3 * 2^-22 of
// |a||b| per product, against plain TF32's 2^-11. The precision is decided
// here, in the kernel: nothing touches PyTorch's process-wide TF32 switch.
//
// What bounds it on an H100: at the SGPR chunk's [8, 500, 500] x [8, 500,
// 4096] it moves 8 + 65.5 + 65.5 MB (about 0.04 ms at 3.35 TB/s) and issues
// 3 x 16.4 GFLOP on the TF32 tensor cores (about 0.10 ms at 495 TFLOP/s):
// operations bound it. The true-f32 product (torch.matmul with TF32 off)
// runs on the SIMT units, 0.245 ms at 67 TFLOP/s at best.
//
// Design, for Hopper (sm_90a). One block of two warpgroups (256 threads)
// per 128 x 128 tile of C; warpgroup w takes rows 64w..64w+63 with
// wgmma.mma_async m64n128k8 .tf32, A from registers and B from shared memory.
//  1. Staging: K in steps of 32, each step's raw f32 tiles of A and B
//     (128 x 32 each) brought in by cp.async into a ring of STAGES = 4
//     stages in dynamic shared memory, two steps ahead of the one being
//     split. A raw tile keeps the operand's global layout, so the copies
//     are coalesced: 16-byte copies where the operand's base, row stride
//     and batch stride are 16-byte multiples, 4-byte copies otherwise (the
//     plan, ops/mm3xtf32.py, says which; a template argument); the ragged
//     edges (M, N or K not a multiple of the tile, the split's K range) are
//     zero-filled by the copy's source size, and no copy reads past a row.
//     16-byte chunks are placed with an XOR swizzle so that the reads below
//     meet no bank conflict. A step's copies are issued after the proxy
//     fence, which waits for the thread's copies in flight.
//  2. Split once per staged tile. B: all 256 threads read each raw element
//     once, round hi and lo (tf32_rna: the tensor cores would only truncate;
//     two integer operations for a finite value) and write them K-major with
//     the 128-byte swizzle, the layout wgmma reads (a K step of 32 f32 is one
//     128-byte row); wgmma takes .tf32 operands K-major only, so a B stored
//     [K][N] (NN) is transposed here, 4 x 4 at a time. The split B tiles
//     are a ring of SPLITS = 3: step k + 1 is split while step k's wgmmas
//     run, into the buffer step k - 2's read. The split writes with
//     ordinary stores and wgmma reads through the async proxy:
//     fence.proxy.async before the barrier that hands the tiles over. A:
//     each thread loads its own wgmma fragment of the raw tile (4 values a
//     K slice of 8, 16 a step: each element of the warpgroup's 64 rows
//     once, from either layout, so a transposed A needs no transposing
//     pass) and splits it in registers; A never goes back to shared memory,
//     which leaves the shared-memory bandwidth to B.
//  3. Each K step's 12 wgmmas (4 slices of 8, lo*hi, hi*lo, hi*hi each,
//     the small terms first) sum into a `part` accumulator from zero
//     (scale-d = 0 on the step's first), and the threads add `part` to the
//     running f32 sum `acc`. With the whole sum kept in the tensor-core
//     accumulator a first version lost 2.3e-6 to 7.0e-6 of |A||B| at K =
//     500 and 4,096 on an H100, 8 to 25 times torch.matmul's f32 error (the
//     accumulation rounds more coarsely than an f32 add). 64 + 64
//     accumulator registers a thread, and 32 for A's split fragments. A
//     warp that issues wgmmas waits until the tensor cores have taken most
//     of them, so the next step's split of B goes between a step's K
//     slices, a quarter after each, where it overlaps them.
//  4. Waves: a block holds 225 KB of shared memory, so one runs per SM. The
//     plan may split K over `splits` blocks a tile when the tiles alone
//     fill too little of the card; each split writes its f32 partial sum to
//     a workspace and a second kernel adds the partials in split order
//     (deterministic). The 128 x 128 tile's result goes from the
//     accumulator registers straight to a bounds-checked store.
//
// Each PTX instruction sits in one named __device__ function below
// (smem_addr .. wgmma_m64n128k8_tf32_rs), which tools/cuda_cpu_emulator.py
// replaces with C++ that does what the PTX ISA says.
//
// Shared memory (dynamic, 230,400 B): the raw ring, 4 x 2 x 16 KB; the split
// B ring, 3 x {hi, lo} x 16 KB; 1 KB to align the tiles to the swizzle's
// 1,024 bytes.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmm3xtf32.so mm3xtf32.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;   // block tile of C, K step
constexpr int THREADS = 256;                 // two warpgroups, 64 rows of the tile each
constexpr int STAGES = 4;                    // the raw tiles' ring
constexpr int SPLITS = 3;                    // the split B tiles' ring
constexpr int TILE = BM * BK;                // floats of one 128 x 32 tile (raw, hi or lo): 16 KB
constexpr int RAW_STAGE = 2 * TILE;          // A and B
constexpr int SPLIT_BUF = 2 * TILE;          // B hi, B lo
constexpr int SWIZZLE_ALIGN = 1024;
constexpr size_t SMEM_BYTES = (STAGES * RAW_STAGE + SPLITS * SPLIT_BUF) * sizeof(float) + SWIZZLE_ALIGN;
constexpr int ACC = 64;                      // accumulator floats a thread of m64n128
constexpr int AFRAG = 4 * (BK / 8);          // A fragment floats a thread of a K step: 4 a slice of 8
constexpr int MAX_DEVICES = 64;

static_assert(BM == BN && BM == 2 * 64, "two warpgroups of m64 rows, one n128 wgmma wide");
static_assert(BK * sizeof(float) == 128, "a K step is one 128-byte swizzle row");
static_assert(TILE / 4 == 4 * THREADS, "a tile is four 16-byte chunks a thread");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on an H100");

struct Operand {
    const float* p;
    long long ld;      // row stride
    long long stride;  // batch stride
    int vec;           // 1: 16-byte copies (base, ld and stride 16-byte multiples)
};

// ---------------------------------------------------------------- PTX
// The shared-state-space address of a shared-memory pointer.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes (4 bytes), the destination's bytes past `bytes`
// zero-filled; `bytes` 0 reads nothing.
__device__ __forceinline__ void cp_async_zfill16(float* dst, const float* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_zfill4(float* dst, const float* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit_group() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ordinary stores to shared memory made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit_group() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait_group() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place: no read or write of them moves across this
// point. The accumulators before a step's first wgmma and after the wait
// that retires its products; A's fragments after that wait (the tensor
// cores read them until then).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for a 64 x 8 A in registers (this thread's fragment a0..a3:
// rows 16 warp + lane / 4 and + 8, columns lane % 4 and + 4 of the
// warpgroup's 64 x 8 A, as m16n8k8's tf32 A) and an 8 x 128 B, tf32
// K-major in shared memory (descriptor db); scale_d 0: d = A B.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[ACC], float a0, float a1, float a2, float a3,
                                                        uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
          "l"(db), "r"(scale_d));
}
// ---------------------------------------------------------------- end of PTX

// The wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, groups of 8 rows 1,024 bytes apart (SBO), the leading offset
// unused (one 32-byte K slice lies inside a swizzled row), base offset 0
// (the tiles are 1,024-byte aligned; a K slice advances the start address).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
           (1ull << 62);
}

// cvt.rna.tf32.f32 on the bits: round to nearest, ties away from zero, to
// 10 mantissa bits; infinities and NaN pass through
__device__ __forceinline__ float tf32_rna(float x) {
    const unsigned u = __float_as_uint(x);
    if ((u & 0x7f800000u) == 0x7f800000u) return x;
    return __uint_as_float((u + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ int clamp4(int v) { return v < 0 ? 0 : (v > 4 ? 4 : v); }

// hi and lo of a value: tf32_rna(x) and tf32_rna(x - hi). For a finite x
// tf32_rna is (bits + 0x1000) & ~0x1fff, two integer operations, so a thread
// whose values are all finite (all_finite: 0 x summed stays 0) takes that;
// one with an infinity or NaN among them takes tf32_rna itself, which lets
// them through.
__device__ __forceinline__ void split_one(bool finite, float x, float& hi, float& lo) {
    if (finite) {
        hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
        lo = __uint_as_float((__float_as_uint(x - hi) + 0x1000u) & 0xffffe000u);
    } else {
        hi = tf32_rna(x);
        lo = tf32_rna(x - hi);
    }
}

template <int N>
__device__ __forceinline__ bool all_finite(const float (&x)[N]) {
    float zero = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) zero = fmaf(x[i], 0.0f, zero);
    return zero == 0.0f;
}

template <int N>
__device__ __forceinline__ void split_values(const float (&x)[N], float (&hi)[N], float (&lo)[N]) {
    const bool finite = all_finite(x);
#pragma unroll
    for (int i = 0; i < N; ++i) split_one(finite, x[i], hi[i], lo[i]);
}

// The swizzles of the raw tiles, by 16-byte chunk: a tile kept [rows][32 k]
// (K contiguous, 8 chunks a row) puts chunk c of row r at c ^ (r % 8); one
// kept [32 k][128 rows] (the rows contiguous, 32 chunks a row) puts chunk c
// of row k at c ^ 2 ((k / 4) % 4) for B (read 4 k x 4 rows by the split) and
// at c ^ 2 (k % 4) for A (read as wgmma fragments). Each makes its reads
// below free of bank conflicts.
template <bool kRowsContiguous, bool kFragments>
__device__ __forceinline__ int raw_chunk(int row, int k_or_c, int c) {
    if (!kRowsContiguous) return row * 8 + (k_or_c ^ (row & 7));                        // row, chunk of K
    return k_or_c * (BM / 4) + (c ^ (kFragments ? 2 * (k_or_c & 3) : 2 * ((k_or_c >> 2) & 3)));  // k, chunk of rows
}

// One operand's raw 128 x 32 tiles of op(X) into shared memory by cp.async,
// a K step at a time: rows [r0, r0 + 128) of op(X) (M of A, N of B; `rows`
// of them exist), K [k0, k0 + 32) clipped to k_end. kRowsContiguous: the
// rows are X's contiguous global dimension (a transposed A, an untransposed
// B), kept [32 k][128 rows]; else [128 rows][32 k]. kVec: 16-byte copies,
// else 4. Each thread copies four 16-byte chunks of a tile, the same four
// places of every tile: their first sources, their places in the stage and
// which of them lie inside the matrix are set once for the block.
template <bool kRowsContiguous, bool kFragments, bool kVec>
struct Stager {
    const float* src;  // chunk 0's source at the range's first K step
    const float* any;  // a valid address for a copy of 0 bytes
    long long apart;   // elements from chunk i's source to chunk i + 1's
    long long ld;
    int k_first;       // K of chunk 0 at the range's first K step
    int k_end;
    int inside;        // K-major: bit i, chunk i's row exists; MN-major: the valid floats of a chunk's row
    int at;            // chunk 0's 16-byte chunk in the stage

    __device__ __forceinline__ Stager(const float* base, long long ld_, const float* any_, int rows, int r0,
                                      int k_begin, int k_end_)
        : any(any_), ld(ld_), k_end(k_end_) {
        if (kRowsContiguous) {
            const int k = threadIdx.x >> 5, c = threadIdx.x & 31;
            src = base + static_cast<long long>(k_begin + k) * ld + r0 + 4 * c;
            apart = 8 * ld;
            k_first = k_begin + k;
            inside = clamp4(rows - r0 - 4 * c);
            at = raw_chunk<true, kFragments>(0, k, c);
        } else {
            const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
            src = base + static_cast<long long>(r0 + r) * ld + k_begin + 4 * c;
            apart = 32 * ld;
            k_first = k_begin + 4 * c;
            inside = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) inside |= (r0 + r + 32 * i < rows) << i;
            at = raw_chunk<false, kFragments>(r, c, 0);
        }
    }

    // K step `step` of the range into `dst`
    __device__ __forceinline__ void load(float* dst, int step) const {
        const float* s = src + (kRowsContiguous ? step * BK * ld : static_cast<long long>(step * BK));
#pragma unroll
        for (int i = 0; i < 4; ++i, s += apart) {
            int valid, place;
            if (kRowsContiguous) {
                const int k = (threadIdx.x >> 5) + 8 * i;  // the chunk's row of the tile
                valid = k_first + 8 * i + step * BK < k_end ? inside : 0;
                place = kFragments ? at + 256 * i : raw_chunk<true, false>(0, k, threadIdx.x & 31);
            } else {
                valid = (inside >> i) & 1 ? clamp4(k_end - k_first - step * BK) : 0;
                place = at + 256 * i;
            }
            float* d = dst + 4 * place;
            if (kVec) {
                cp_async_zfill16(d, valid > 0 ? s : any, 4 * valid);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) cp_async_zfill4(d + j, j < valid ? s + j : any, j < valid ? 4 : 0);
            }
        }
    }
};

// B's raw tile split into its hi and lo tiles, [128 rows][32 k] with the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)), in two parts
// so that the emitting can go between a step's wgmmas. Each thread takes
// four 16-byte chunks: split_gather reads their 16 values, x[4i + j] value j
// of output chunk i, whose place is at[i]; a transposed raw tile
// (kRowsContiguous) is read 4 k x 4 rows at a time and transposed in
// registers. split_emit writes output chunk i's hi and lo. Neither the reads
// nor the writes meet a bank conflict.
template <bool kRowsContiguous>
__device__ __forceinline__ void split_gather(const float* raw, float (&x)[16], int (&at)[4]) {
    const float4* r4 = reinterpret_cast<const float4*>(raw);
    if (kRowsContiguous) {
        const int l8 = threadIdx.x & 7, grp = threadIdx.x >> 3;
        const int q = (l8 & 3) + 4 * (grp & 1);    // K chunk: k = 4q .. 4q + 3
        const int c = (l8 >> 2) + 2 * (grp >> 1);  // row chunk: rows 4c .. 4c + 3
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // x[4i + j]: row 4c + i, k 4q + j
            const float4 v = r4[raw_chunk<true, false>(0, 4 * q + j, c)];
            x[j] = v.x;
            x[4 + j] = v.y;
            x[8 + j] = v.z;
            x[12 + j] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) at[i] = (4 * c + i) * 8 + (q ^ ((4 * c + i) & 7));
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            at[i] = raw_chunk<false, false>((threadIdx.x >> 3) + 32 * i, threadIdx.x & 7, 0);
            const float4 v = r4[at[i]];
            x[4 * i] = v.x;
            x[4 * i + 1] = v.y;
            x[4 * i + 2] = v.z;
            x[4 * i + 3] = v.w;
        }
    }
}

__device__ __forceinline__ void split_emit(float* hi, float* lo, const float (&x)[16], int at, int i, bool finite) {
    float h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_one(finite, x[4 * i + j], h[j], l[j]);
    reinterpret_cast<float4*>(hi)[at] = make_float4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<float4*>(lo)[at] = make_float4(l[0], l[1], l[2], l[3]);
}

// This thread's A fragments of one K step from the raw tile: for K slice s,
// a[4s + j] is A(row + 8 (j % 2), 8s + lane % 4 + 4 (j / 2)), row = 64 wg
// + 16 warp + lane / 4 (m16n8k8's tf32 A layout, a warp's 16 rows).
template <bool kRowsContiguous>
__device__ __forceinline__ void load_fragments(float (&a)[AFRAG], const float* raw, int wg) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int row = wg * 64 + warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int m = row + 8 * (j & 1), k = 8 * s + t + 4 * (j >> 1);
            a[4 * s + j] = kRowsContiguous ? raw[4 * raw_chunk<true, true>(0, k, m >> 2) + (m & 3)]
                                           : raw[4 * raw_chunk<false, true>(m, k >> 2, 0) + (k & 3)];
        }
}

// kTA: op(A) = A^T (A stored [K][M]), else A [M][K]; kTB: op(B) = B^T (B
// stored [N][K]), else B [K][N]; kVecA, kVecB: 16-byte copies. Block id ->
// (batch, split, tile of C); split s sums K [s kchunk, (s + 1) kchunk)
// into out[s][batch][M][N] (out = C when splits is 1).
template <bool kTA, bool kTB, bool kVecA, bool kVecB>
__global__ void __launch_bounds__(THREADS, 1) mm3xtf32_kernel(Operand a, Operand b, float* __restrict__ out,
                                                              int batch, int M, int N, int K, int tiles_n,
                                                              int tiles, int splits, int kchunk) {
    extern __shared__ __align__(1024) float smem_dyn[];
    const unsigned pad = (SWIZZLE_ALIGN - smem_addr(smem_dyn) % SWIZZLE_ALIGN) % SWIZZLE_ALIGN;
    float* raw = smem_dyn + pad / sizeof(float);
    float* split_bufs = raw + STAGES * RAW_STAGE;

    int id = blockIdx.x;
    const int t = id % tiles;
    id /= tiles;
    const int split = id % splits, bat = id / splits;
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    const int k_begin = split * kchunk;
    const int k_end = K < k_begin + kchunk ? K : k_begin + kchunk;
    const int steps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
    const float* pa = a.p + bat * a.stride;
    const float* pb = b.p + bat * b.stride;
    const int wg = threadIdx.x / 128;
    const Stager<kTA, true, kVecA> stage_a(pa, a.ld, a.p, M, m0, k_begin, k_end);
    const Stager<!kTB, false, kVecB> stage_b(pb, b.ld, b.p, N, n0, k_begin, k_end);
    auto load_step = [&](int step) {
        float* r = raw + (step % STAGES) * RAW_STAGE;
        stage_a.load(r, step);
        stage_b.load(r + TILE, step);
    };

    float acc[ACC], part[ACC], x[AFRAG], hi[AFRAG], lo[AFRAG];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < steps) load_step(s);
        cp_async_commit_group();  // one group a step, empty past the last
    }
    float bx[16];  // the next step's raw B values for the split
    int b_at[4];   // and their output chunks' places
    if (steps > 0) {  // step 0's split B and A fragments
        cp_async_wait_group<STAGES - 2>();
        __syncthreads();
        split_gather<!kTB>(raw + TILE, bx, b_at);
        const bool finite = all_finite(bx);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_emit(split_bufs, split_bufs + TILE, bx, b_at[i], i, finite);
        load_fragments<kTA>(x, raw, wg);
        fence_proxy_async();
    }
    // Step k: its split B tile and A's raw fragments were made in the
    // previous iteration. Its 12 wgmmas go out a K slice (3 wgmmas) at a
    // time, each followed by a quarter of step k + 1's split of B (a warp
    // that issues wgmmas waits until the tensor cores take most of them:
    // work between them overlaps, work after them mostly does not).
    for (int k = 0; k < steps; ++k) {
        cp_async_wait_group<STAGES - 3>();  // this thread's copies of step k + 1
        // everyone's; step k's split B is whole; both warpgroups' step k - 2
        // wgmmas, which read the split buffer step k + 1 takes, are done
        __syncthreads();
        if (k > 0) {
            wgmma_wait_group<0>();
            fence_operand(part);
            fence_operand(hi);
            fence_operand(lo);
#pragma unroll
            for (int i = 0; i < ACC; ++i) acc[i] += part[i];
        }
        split_values(x, hi, lo);
        const bool more = k + 1 < steps;
        const float* r_next = raw + ((k + 1) % STAGES) * RAW_STAGE;
        float* b_next = split_bufs + ((k + 1) % SPLITS) * SPLIT_BUF;
        bool finite = true;
        if (more) {
            split_gather<!kTB>(r_next + TILE, bx, b_at);
            finite = all_finite(bx);
        }
        const float* buf = split_bufs + (k % SPLITS) * SPLIT_BUF;
        const unsigned b_hi = smem_addr(buf), b_lo = smem_addr(buf + TILE);
        fence_operand(part);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < BK / 8; ++s) {
            const unsigned o = s * 8 * sizeof(float);  // the K slice's bytes into the swizzled row
            const int f = 4 * s;
            wgmma_m64n128k8_tf32_rs(part, lo[f], lo[f + 1], lo[f + 2], lo[f + 3], sw128_desc(b_hi + o), s > 0);
            wgmma_m64n128k8_tf32_rs(part, hi[f], hi[f + 1], hi[f + 2], hi[f + 3], sw128_desc(b_lo + o), 1);
            wgmma_m64n128k8_tf32_rs(part, hi[f], hi[f + 1], hi[f + 2], hi[f + 3], sw128_desc(b_hi + o), 1);
            if (more) split_emit(b_next, b_next + TILE, bx, b_at[s], s, finite);
        }
        wgmma_commit_group();  // `part` and the fragments are the tensor cores' until wgmma_wait_group: no
                               // fence_operand here, which would make ptxas wait for the products at once
        if (more) load_fragments<kTA>(x, r_next, wg);
        fence_proxy_async();  // step k + 1's split B, for its wgmmas
        // step k + 3 into the stage of step k - 1; issued after the fence,
        // which would wait for them
        if (k + STAGES - 1 < steps) load_step(k + STAGES - 1);
        cp_async_commit_group();
    }
    if (steps > 0) {
        wgmma_wait_group<0>();
        fence_operand(part);
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] += part[i];
    }

    // the m64n128 accumulator: element 4j + 2h + e of a thread sits at row
    // 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
    out += (static_cast<long long>(split) * batch + bat) * M * N;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
    const int col = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int r = row + 8 * h, c = col + 8 * j + e;
                if (r < M && c < N) out[static_cast<long long>(r) * N + c] = acc[4 * j + 2 * h + e];
            }
}

// C = the sum of the splits' partials, in split order.
__global__ void __launch_bounds__(256) sum_splits_kernel(const float* __restrict__ parts, float* __restrict__ C,
                                                         long long n, int splits) {
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        float s = parts[i];
        for (int p = 1; p < splits; ++p) s += parts[p * n + i];
        C[i] = s;
    }
}

bool configured[MAX_DEVICES];  // the shared-memory opt-in, set once per device

template <bool kTA, bool kTB, bool kVecA, bool kVecB>
cudaError_t allow_smem() {
    return cudaFuncSetAttribute(mm3xtf32_kernel<kTA, kTB, kVecA, kVecB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(SMEM_BYTES));
}

template <bool kTA, bool kTB>
cudaError_t allow_smem_widths() {
    cudaError_t err = allow_smem<kTA, kTB, true, true>();
    if (err == cudaSuccess) err = allow_smem<kTA, kTB, true, false>();
    if (err == cudaSuccess) err = allow_smem<kTA, kTB, false, true>();
    if (err == cudaSuccess) err = allow_smem<kTA, kTB, false, false>();
    return err;
}

cudaError_t configure() {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && configured[dev]) return cudaSuccess;
    err = allow_smem_widths<false, false>();
    if (err == cudaSuccess) err = allow_smem_widths<false, true>();
    if (err == cudaSuccess) err = allow_smem_widths<true, false>();
    if (err == cudaSuccess) err = allow_smem_widths<true, true>();
    if (err == cudaSuccess && dev < MAX_DEVICES) configured[dev] = true;
    return err;
}

template <bool kTA, bool kTB, bool kVecA, bool kVecB>
cudaError_t launch_mm(const Operand& a, const Operand& b, float* out, int batch, int M, int N, int K, int tiles_n,
                      int tiles, int splits, int kchunk, int grid, cudaStream_t stream) {
    mm3xtf32_kernel<kTA, kTB, kVecA, kVecB><<<grid, THREADS, SMEM_BYTES, stream>>>(a, b, out, batch, M, N, K, tiles_n,
                                                                                   tiles, splits, kchunk);
    return cudaGetLastError();
}

template <bool kTA, bool kTB>
cudaError_t launch_widths(const Operand& a, const Operand& b, float* out, int batch, int M, int N, int K,
                          int tiles_n, int tiles, int splits, int kchunk, int g, cudaStream_t s) {
    if (a.vec)
        return b.vec
                   ? launch_mm<kTA, kTB, true, true>(a, b, out, batch, M, N, K, tiles_n, tiles, splits, kchunk, g, s)
                   : launch_mm<kTA, kTB, true, false>(a, b, out, batch, M, N, K, tiles_n, tiles, splits, kchunk, g, s);
    return b.vec
               ? launch_mm<kTA, kTB, false, true>(a, b, out, batch, M, N, K, tiles_n, tiles, splits, kchunk, g, s)
               : launch_mm<kTA, kTB, false, false>(a, b, out, batch, M, N, K, tiles_n, tiles, splits, kchunk, g, s);
}

// 16-byte copies need the base, the row stride and the batch stride in
// 16-byte multiples
bool vec16_ok(const void* p, long long ld, long long stride, int batch) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0 && (batch == 1 || stride % 4 == 0);
}

}  // namespace

extern "C" {

// C[b] = op(A[b]) op(B[b]) for b < batch, as planned by ops/mm3xtf32.py's
// `plan`: op(A) M x K, op(B) K x N, all f32 device pointers. A is [M][K]
// (transA = 0) or [K][M] (transA = 1) with leading dimension lda and batch
// stride strideA; B is [K][N] (transB = 0) or [N][K] (transB = 1),
// likewise. vecA, vecB: 16-byte copies of that operand (refused where its
// base, row stride or batch stride is not a 16-byte multiple). splits >= 1:
// K cut into `splits` ranges of whole K steps, summed into `workspace`
// ([splits][batch][M][N] f32, unused when splits is 1) and added in split
// order. C is [batch][M][N] contiguous. stream: a cudaStream_t. Returns the
// cudaError_t of the launches (0 on success); an empty product launches
// nothing.
int gpsat_mm3xtf32_plan_f32(const void* A, long long lda, long long strideA, int transA, int vecA, const void* B,
                            long long ldb, long long strideB, int transB, int vecB, void* C, void* workspace,
                            int batch, int M, int N, int K, int splits, void* stream) {
    if (batch <= 0 || M <= 0 || N <= 0) return 0;
    if (K < 0 || splits < 1 || (splits > 1 && workspace == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    if ((vecA && !vec16_ok(A, lda, strideA, batch)) || (vecB && !vec16_ok(B, ldb, strideB, batch)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int steps = (K + BK - 1) / BK;
    const int kchunk = ((steps + splits - 1) / splits) * BK;
    const int tiles_n = (N + BN - 1) / BN;
    const long long tiles = static_cast<long long>((M + BM - 1) / BM) * tiles_n;
    const long long grid = tiles * batch * splits;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = configure();
    if (err != cudaSuccess) return static_cast<int>(err);
    const Operand a{static_cast<const float*>(A), lda, strideA, vecA ? 1 : 0};
    const Operand b{static_cast<const float*>(B), ldb, strideB, vecB ? 1 : 0};
    auto* c = static_cast<float*>(C);
    float* out = splits > 1 ? static_cast<float*>(workspace) : c;
    auto s = static_cast<cudaStream_t>(stream);
    const int t = static_cast<int>(tiles), g = static_cast<int>(grid);
    if (transA) {
        err = transB ? launch_widths<true, true>(a, b, out, batch, M, N, K, tiles_n, t, splits, kchunk, g, s)
                     : launch_widths<true, false>(a, b, out, batch, M, N, K, tiles_n, t, splits, kchunk, g, s);
    } else {
        err = transB ? launch_widths<false, true>(a, b, out, batch, M, N, K, tiles_n, t, splits, kchunk, g, s)
                     : launch_widths<false, false>(a, b, out, batch, M, N, K, tiles_n, t, splits, kchunk, g, s);
    }
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const long long n = static_cast<long long>(batch) * M * N;
    const long long want = (n + 255) / 256;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    sum_splits_kernel<<<blocks, 256, 0, s>>>(out, c, n, splits);
    return static_cast<int>(cudaGetLastError());
}

// The same product with no plan: one split, 16-byte copies of each operand
// that allows them.
int gpsat_mm3xtf32_f32(const void* A, long long lda, long long strideA, int transA, const void* B, long long ldb,
                       long long strideB, int transB, void* C, int batch, int M, int N, int K, void* stream) {
    return gpsat_mm3xtf32_plan_f32(A, lda, strideA, transA, vec16_ok(A, lda, strideA, batch) ? 1 : 0, B, ldb,
                                   strideB, transB, vec16_ok(B, ldb, strideB, batch) ? 1 : 0, C, nullptr, batch,
                                   M, N, K, 1, stream);
}

// The dynamic shared memory a block of the product asks for, in bytes.
int gpsat_mm3xtf32_smem_bytes() { return static_cast<int>(SMEM_BYTES); }

}  // extern "C"
