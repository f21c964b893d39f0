"""Run the port's CUDA kernel sources on the CPU, one thread per CUDA thread,
and hold them against their plain PyTorch versions at small shapes.

    python tools/cuda_cpu_emulator.py [--kernels cholesky panel_chol block_chol mm3xtf32] [--out DIR]

For a machine with no nvcc and no card: it checks a kernel's indexing,
barriers and arithmetic order before a first run on the card, not its speed
and not what nvcc would refuse. Each `gpsat_tpu_torch/csrc/<name>.cu` is
rewritten for g++ (the runtime header below in place of cuda_runtime.h,
`<<<grid, block, ...>>>` launches as calls of `emu_launch`, cp.async copies
as plain 16-byte copies, shared memory as static arrays, nvcuda::wmma
fragments as whole tiles held by every thread), built
with g++ -std=c++20 into DIR (default: a temporary directory) and loaded
with ctypes. Blocks run one after another; the threads of a block run
concurrently, `__syncthreads` and `__syncwarp` are std::barriers and
`__shfl_sync` goes through a per-warp buffer, so a missing barrier can show
as a wrong answer (not on every run). `rsqrtf` and `__frcp_rn` are exact
here, where the card's rsqrtf is approximate: compare at the kernel's
tolerances, not bit for bit. Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "gpsat_tpu_torch" / "csrc"

RUNTIME_H = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
struct EmuBlock {
    std::unique_ptr<std::barrier<>> all;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    std::vector<float> xchg;
};
inline EmuBlock* emu_block = nullptr;
inline void __syncthreads() { emu_block->all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warps[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src) {
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
    emu_block->xchg[w * 32 + l] = v;
    __syncwarp();
    const float r = emu_block->xchg[w * 32 + src];
    __syncwarp();
    return r;
}
inline float __frcp_rn(float x) { return 1.0f / x; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
template <class T> inline T __ldg(const T* p) { return *p; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
    cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
    cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum cudaSharedCarveout { cudaSharedmemCarveoutMaxL1 = 0, cudaSharedmemCarveoutMaxShared = 100 };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
template <class F> inline cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) { return cudaSuccess; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*, int, size_t) {
    *n = -1;
    return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
// nvcuda::wmma, one whole fragment per thread: every thread of a warp holds
// all of a fragment's elements (num_elements is the tile's size) and does the
// warp's whole product itself, so an element-wise pass over x[] (the same
// operation on every element) acts as on the card; a store is made by lane 0.
// tf32 inputs are truncated to their top 19 bits, as the tensor cores read them.
namespace nvcuda { namespace wmma {
struct row_major {}; struct col_major {};
struct matrix_a {}; struct matrix_b {}; struct accumulator {};
namespace precision { struct tf32 {}; }
enum layout_t { mem_row_major, mem_col_major };
template <class Use, int M, int N, int K, class T, class Layout = void> struct fragment {
    static constexpr int rows = std::is_same_v<Use, matrix_b> ? K : M;
    static constexpr int cols = std::is_same_v<Use, matrix_a> ? K : N;
    static constexpr int num_elements = rows * cols;
    float x[num_elements];
};
template <class Use, int M, int N, int K, class T, class L>
inline void load_matrix_sync(fragment<Use, M, N, K, T, L>& f, const float* p, unsigned ld) {
    using F = fragment<Use, M, N, K, T, L>;
    for (int r = 0; r < F::rows; ++r)
        for (int c = 0; c < F::cols; ++c)
            f.x[r * F::cols + c] = std::is_same_v<L, col_major> ? p[r + c * ld] : p[r * ld + c];
}
template <class Use, int M, int N, int K, class T, class L>
inline void fill_fragment(fragment<Use, M, N, K, T, L>& f, float v) {
    for (auto& e : f.x) e = v;
}
inline float emu_tf32_input(float v) { return __uint_as_float(__float_as_uint(v) & 0xffffe000u); }
template <int M, int N, int K, class T, class LA, class LB>
inline void mma_sync(fragment<accumulator, M, N, K, float>& d, const fragment<matrix_a, M, N, K, T, LA>& a,
                     const fragment<matrix_b, M, N, K, T, LB>& b, const fragment<accumulator, M, N, K, float>& c) {
    float out[M * N];
    for (int m = 0; m < M; ++m)
        for (int n = 0; n < N; ++n) {
            float s = c.x[m * N + n];
            for (int k = 0; k < K; ++k) s += emu_tf32_input(a.x[m * K + k]) * emu_tf32_input(b.x[k * N + n]);
            out[m * N + n] = s;
        }
    std::memcpy(d.x, out, sizeof(out));
}
template <int M, int N, int K>
inline void store_matrix_sync(float* p, const fragment<accumulator, M, N, K, float>& f, unsigned ld, layout_t layout) {
    __syncwarp();
    if (threadIdx.x % 32 == 0)
        for (int r = 0; r < M; ++r)
            for (int c = 0; c < N; ++c) p[layout == mem_col_major ? r + c * ld : r * ld + c] = f.x[r * N + c];
    __syncwarp();
}
}}  // namespace nvcuda::wmma
inline void emu_launch(int grid, int block, const std::function<void()>& body) {
    gridDim.x = grid;
    blockDim.x = block;
    for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        EmuBlock eb;
        eb.all = std::make_unique<std::barrier<>>(block);
        for (int w = 0; w < block / 32; ++w) eb.warps.push_back(std::make_unique<std::barrier<>>(32));
        eb.xchg.assign(block, 0.0f);
        emu_block = &eb;
        std::vector<std::thread> ts;
        for (int t = 0; t < block; ++t) ts.emplace_back([t, &body] { threadIdx.x = t; body(); });
        for (auto& t : ts) t.join();
    }
}
"""

SMEM_FLOATS = 65536  # 256 KB, more than a block may have on the card


def rewrite(text: str) -> str:
    """A kernel source or header, rewritten for g++ and the runtime above."""
    text = text.replace("#include <cuda_runtime.h>", '#include "emu_runtime.h"').replace("#include <mma.h>", "")
    text = re.sub(r'asm volatile\("cp\.async\.cg.*?\)\);', "std::memcpy(dst, src, 16);", text, flags=re.S)
    text = re.sub(r"const unsigned d = static_cast<unsigned>\(__cvta_generic_to_shared\(dst\)\);", "", text)
    text = re.sub(r"asm volatile\(.*?\);", "", text, flags=re.S)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];", r"float* \1 = emu_smem;", text)
    text = re.sub(r"__shared__ (?:__align__\(\d+\) )?(float \w+\[[^\]]+\];)", r"alignas(16) static \1",
                  text)  # blocks run one at a time
    text = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),[^;]*?>>>\((.*?)\);",
                  r"emu_launch(\2, \3, [&]{ \1(\4); });", text, flags=re.S)
    return re.sub(r"^namespace \{", f"namespace {{\nalignas(16) float emu_smem[{SMEM_FLOATS}];", text, count=1,
                  flags=re.M)


def build(name: str, out: Path) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    (out / "emu_runtime.h").write_text(RUNTIME_H)
    for header in CSRC.glob("*.cuh"):
        (out / header.name).write_text(rewrite(header.read_text()))
    src = out / f"{name}.cpp"
    src.write_text(rewrite((CSRC / f"{name}.cu").read_text()))
    lib = out / f"lib{name}_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas", f"-I{out}",
           "-o", str(lib), str(src)]
    subprocess.run(cmd, check=True)
    return ctypes.CDLL(str(lib))


def spd(B, n, seed):
    A = np.random.default_rng(seed).standard_normal((B, n, n)).astype(np.float32)
    return torch.from_numpy(A @ np.swapaxes(A, 1, 2) + n * np.eye(n, dtype=np.float32))


def check(name, ok, **numbers):
    print(f"{'ok  ' if ok else 'FAIL'} {name} {numbers}", flush=True)
    return ok


def run_cholesky(lib) -> bool:
    from gpsat_tpu_torch.ops import cholesky as CH

    fn = lib.gpsat_cholesky_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def chol(K):
        L = torch.full_like(K, float("nan"))  # every element must be written
        if fn(K.data_ptr(), L.data_ptr(), K.shape[0], K.shape[-1], None) != 0:
            raise RuntimeError("gpsat_cholesky_f32 refused its input")
        return L

    ok = True
    for B, n in ((1, 128), (2, 256), (1, 384)):
        K = spd(B, n, seed=n)
        L = chol(K)
        err = float((L - CH.cholesky_reference(K)).abs().max())
        err_llt = float((L @ L.transpose(1, 2) - K).abs().max())
        upper = float(torch.triu(L, 1).abs().max())
        ok &= check(f"cholesky [{B}, {n}, {n}]", err <= 2e-4 and err_llt <= 1e-5 * n and upper == 0.0,
                    max_abs_err=err, max_abs_LLt_minus_K=err_llt)
    eye = torch.eye(256)
    L = chol(torch.stack([eye, -eye]))
    return ok & check("cholesky -I beside I", torch.equal(L[0], eye) and bool(torch.isnan(L[1]).any()))


def run_panel_chol(lib) -> bool:
    from gpsat_tpu_torch.ops import panel_chol as PC

    fn = lib.gpsat_panel128_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    K = torch.cat([spd(2, 128, seed=1), torch.zeros(1, 128, 128), torch.eye(128)[None]])
    L, W = torch.empty_like(K), torch.empty_like(K)
    if fn(K.data_ptr(), L.data_ptr(), W.data_ptr(), K.shape[0], None) != 0:
        raise RuntimeError("gpsat_panel128_f32 refused its input")
    Lr, Wr = PC.factor_panels_reference(K)
    err_L, err_W = float((L - Lr).abs().max()), float((W - Wr).abs().max())
    return check("panel_chol [4, 128, 128]", err_L <= 2e-4 and err_W <= 2e-5 and torch.equal(L[3], torch.eye(128)),
                 max_abs_err_L=err_L, max_abs_err_Linv=err_W)


def run_block_chol(lib) -> bool:
    from gpsat_tpu_torch.ops import block_chol as BC

    fn = lib.gpsat_cholinv64_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def factor(K):
        L, W = torch.full_like(K, float("nan")), torch.full_like(K, float("nan"))  # every element must be written
        if fn(K.data_ptr(), L.data_ptr(), W.data_ptr(), K.shape[0], None) != 0:
            raise RuntimeError("gpsat_cholinv64_f32 refused its input")
        return L, W

    ok = True
    eye = torch.eye(64)
    for B in (1, 3, 133):
        K = spd(B, 64, seed=B)
        L, W = factor(K)
        Lr, Wr = BC.factor_blocks_reference(K)
        Le, We = BC.factor_blocks_blocked_emulation(K)
        err_L, err_W = float((L - Lr).abs().max()), float((W - Wr).abs().max())
        emu_L, emu_W = float((L - Le).abs().max()), float((W - We).abs().max())
        err_LW = float((L @ W - eye).abs().max())
        upper = max(float(torch.triu(L, 1).abs().max()), float(torch.triu(W, 1).abs().max()))
        ok &= check(f"block_chol [{B}, 64, 64]",
                    max(err_L, err_W, err_LW) <= 1e-4 and max(emu_L, emu_W) <= 2e-5 and upper == 0.0,
                    max_abs_err_L=err_L, max_abs_err_W=err_W, vs_emulation_L=emu_L, vs_emulation_W=emu_W,
                    max_abs_LW_minus_I=err_LW)
    L, W = factor(torch.stack([eye, -eye, spd(1, 64, seed=5)[0]]))
    exact = torch.equal(L[0], eye) and torch.equal(W[0], eye)
    nan = bool(torch.isnan(L[1]).any()) and bool(torch.isnan(W[1]).any())
    finite = bool(torch.isfinite(L[2]).all()) and bool(torch.isfinite(W[2]).all())
    return ok & check("block_chol I, -I, SPD", exact and nan and finite, identity_exact=exact, nan_in_minus_I=nan,
                      spd_beside_finite=finite)


def run_mm3xtf32(lib) -> bool:
    from gpsat_tpu_torch.ops import mm3xtf32 as MM

    fn = lib.gpsat_mm3xtf32_f32
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, ll, ll, i, vp, ll, ll, i, vp, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    ok = True
    # ragged shapes (none a multiple of the 64 x 64 tile or of the K step of
    # 32), every orientation, a sliced operand (row stride above its width)
    for (batch, M, N, K), ta, tb in [((2, 70, 90, 45), False, False), ((1, 70, 90, 45), True, False),
                                     ((1, 33, 65, 100), False, True), ((2, 17, 129, 9), True, True)]:
        a = torch.from_numpy(rng.standard_normal((batch, K, M) if ta else (batch, M, K)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((batch, N, K) if tb else (batch, K, N)).astype(np.float32))
        cases = {"": (a, b)}
        if not ta:
            wide = torch.zeros(batch, M, K + 7)
            wide[:, :, :K] = a
            cases["a sliced"] = (wide[:, :, :K], b)
        for tag, (x, y) in cases.items():
            C = torch.full((batch, M, N), float("nan"))  # every element must be written
            if fn(x.data_ptr(), x.stride(1), x.stride(0), int(ta), y.data_ptr(), y.stride(1), y.stride(0), int(tb),
                  C.data_ptr(), batch, M, N, K, None) != 0:
                raise RuntimeError("gpsat_mm3xtf32_f32 refused its input")
            ref = MM.mm3xtf32_reference(x, y, ta, tb)
            scale = float(torch.matmul(MM._op(x, ta).abs(), MM._op(y, tb).abs()).max())
            err = float((C - ref).abs().max()) / scale
            ok &= check(f"mm3xtf32 [{batch}, {M}, {N}, {K}] ta={ta} tb={tb} {tag}".rstrip(), err <= 1e-6,
                        max_abs_err_rel=err)
    return ok


RUNS = {"cholesky": run_cholesky, "panel_chol": run_panel_chol, "block_chol": run_block_chol,
        "mm3xtf32": run_mm3xtf32}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", nargs="+", choices=sorted(RUNS), default=sorted(RUNS))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or Path(tmp)
        ok = all([RUNS[name](build(name, out / name)) for name in args.kernels])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
