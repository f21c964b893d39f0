"""Run the port's CUDA kernel sources on the CPU, one thread per CUDA thread,
and hold them against their plain PyTorch versions at small shapes.

    python tools/cuda_cpu_emulator.py [--kernels cholesky panel_chol block_chol] [--out DIR]

For a machine with no nvcc and no card: it checks a kernel's indexing,
barriers and arithmetic order before a first run on the card, not its speed
and not what nvcc would refuse. Each `gpsat_tpu_torch/csrc/<name>.cu` is
rewritten for g++ (the runtime header below in place of cuda_runtime.h,
`<<<grid, block, ...>>>` launches as calls of `emu_launch`, cp.async copies
as plain 16-byte copies, shared memory as static arrays), built
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
    text = text.replace("#include <cuda_runtime.h>", '#include "emu_runtime.h"')
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


RUNS = {"cholesky": run_cholesky, "panel_chol": run_panel_chol, "block_chol": run_block_chol}


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
