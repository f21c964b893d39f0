"""Run the port's CUDA kernel sources on the CPU, one thread per CUDA thread,
and hold them against their plain PyTorch versions at small shapes.

    python tools/cuda_cpu_emulator.py [--kernels cholesky panel_chol block_chol mm3xtf32] [--out DIR]

For a machine with no nvcc and no card: it checks a kernel's indexing,
barriers and arithmetic order before a first run on the card, not its speed
and not what nvcc or ptxas would refuse. Each `gpsat_tpu_torch/csrc/<name>.cu`
is rewritten for g++ (the runtime header below in place of cuda_runtime.h,
`<<<grid, block, ...>>>` launches as calls of `emu_launch`, kernels 1-3's
cp.async copies as plain 16-byte copies, shared memory as static arrays,
and each named PTX function of kernel 4, `PTX_FUNCTIONS`, replaced by C++
that does what the PTX ISA says: its cp.async copies and wgmma products
queued at issue and done when a wait retires them, its descriptors and
128-byte swizzle decoded), built with g++ -std=c++20 into DIR (default: a
temporary directory) and loaded with ctypes. Blocks run one after another;
the threads of a block run concurrently, `__syncthreads` and `__syncwarp`
are std::barriers and `__shfl_sync` goes through a per-warp buffer, so a
missing barrier can show as a wrong answer (not on every run). `rsqrtf` and
`__frcp_rn` are exact here, where the card's rsqrtf is approximate: compare
at the kernel's tolerances, not bit for bit. Not shown: timing, a missing
proxy fence (ordinary stores are seen by the emulated wgmma at once), the
register file (`setmaxnreg`, spills) and the card's own NaN bits from
arithmetic (the CPU's differ; inputs can carry the card's). Exits non-zero
if a check fails.
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
#include <array>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
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
    std::vector<std::unique_ptr<std::barrier<>>> warps, warpgroups;
    std::vector<float> xchg;
    // register A operands of wgmma, per warpgroup and instruction: the 128
    // threads' 4 values each, published at issue
    std::mutex fragments_lock;
    std::vector<std::deque<std::array<float, 512>>> fragments;
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
// the tensor cores read a tf32 input's top 19 bits
inline float emu_tf32_input(float v) { return __uint_as_float(__float_as_uint(v) & 0xffffe000u); }
// Faults the card would show as a crash or a wrong answer: counted, the
// first few printed; emu_faults() reads the count.
inline std::atomic<int> emu_fault_count{0};
inline void emu_fault(const char* what) {
    if (emu_fault_count.fetch_add(1) < 8) std::fprintf(stderr, "emulator fault: %s\n", what);
}
extern "C" int emu_faults() { return emu_fault_count.load(); }
// A shared-memory pointer's address in the shared state space: its offset
// into the block's shared memory (256 KB).
inline unsigned emu_shared_address(const void* p, const void* base) {
    const std::ptrdiff_t d = static_cast<const char*>(p) - static_cast<const char*>(base);
    if (d < 0 || d >= 262144) emu_fault("a shared-memory address outside the block's shared memory");
    return static_cast<unsigned>(d);
}
// cp.async and wgmma.mma_async are asynchronous on the card. Here each
// thread queues its copies and products at issue and does them when a wait
// retires their group (cp.async.wait_group N, wgmma.wait_group N: all but
// the N newest committed groups), the latest moment the card may: a read of
// the destination before the wait sees the old contents, and a write to a
// product's operand tiles before its wait changes the product.
struct EmuCopy { void* dst; const void* src; int size, bytes; };
struct EmuMma { float* d; int n; std::uint64_t db; int scale_d; const float* a; };
struct EmuQueues {
    int rs_issued = 0;
    std::vector<EmuCopy> open_copies;
    std::deque<std::vector<EmuCopy>> copies;
    std::vector<EmuMma> open_mmas;
    std::deque<std::vector<EmuMma>> mmas;
};
inline thread_local EmuQueues emu_q;
// cp.async.{ca,cg}.shared.global [dst], [src], size, bytes: `bytes` of src,
// then zeros to `size`; both addresses aligned to `size`
inline void emu_cp_async(void* dst, const void* src, int size, int bytes, const void* smem) {
    if (bytes < 0 || bytes > size) emu_fault("cp.async source size outside [0, copy size]");
    if (emu_shared_address(dst, smem) % size != 0 || reinterpret_cast<std::uintptr_t>(src) % size != 0)
        emu_fault("cp.async address not aligned to the copy size");
    emu_q.open_copies.push_back({dst, src, size, bytes});
}
inline void emu_cp_async_commit() {
    emu_q.copies.push_back(std::move(emu_q.open_copies));
    emu_q.open_copies.clear();
}
inline void emu_cp_async_wait(int n) {
    while (static_cast<int>(emu_q.copies.size()) > n) {
        for (const auto& c : emu_q.copies.front()) {
            std::memcpy(c.dst, c.src, c.bytes);
            std::memset(static_cast<char*>(c.dst) + c.bytes, 0, c.size - c.bytes);
        }
        emu_q.copies.pop_front();
    }
}
// One element of a K-major tf32 operand tile through its wgmma descriptor
// (start address >> 4 in bits 0-13, the stride between 8-row groups >> 4 in
// bits 32-45, the layout in bits 62-63): only the 128-byte swizzle (layout
// 1) at base offset 0, where row r of a group lies 128 bytes after row r - 1
// and the hardware XORs address bits 4-6 with bits 7-9
inline float emu_sw128_element(const char* smem, std::uint64_t desc, int row, int k) {
    if ((desc >> 62) != 1 || ((desc >> 49) & 7) != 0)
        emu_fault("wgmma descriptor: not a 128-byte swizzle at base offset 0");
    const unsigned start = static_cast<unsigned>(desc & 0x3FFF) << 4;
    const unsigned sbo = static_cast<unsigned>((desc >> 32) & 0x3FFF) << 4;
    const unsigned addr = start + (row / 8) * sbo + (row % 8) * 128 + k * 4;
    const unsigned phys = addr ^ (((addr >> 7) & 7) << 4);
    if (phys + 4 > 262144) emu_fault("wgmma operand outside the block's shared memory");
    float v;
    std::memcpy(&v, smem + phys, 4);
    return v;
}
// The A element (row, k) of a register A operand of m64nNk8 .tf32: thread
// 32 (row / 16) + 4 (row % 8) + k % 4 of the warpgroup holds it, in its
// register (row % 16) / 8 + 2 (k / 4) (m16n8k8's tf32 A layout, a warp's 16
// rows)
inline float emu_fragment_element(const float* a, int row, int k) {
    return a[4 * (32 * (row / 16) + 4 * (row % 8) + k % 4) + (row % 16) / 8 + 2 * (k / 4)];
}
// wgmma.mma_async m64nNk8 .f32.tf32.tf32, A from the warpgroup's
// registers, B from shared memory: this thread's N / 2 accumulator
// elements, element 4j + 2h + e at row 16 warp + lane / 4 + 8h, column 8j
// + 2 (lane % 4) + e of the warpgroup's 64 x N tile
inline void emu_wgmma_run(const EmuMma& op, const char* smem) {
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    for (int i = 0; i < op.n / 2; ++i) {
        const int j = i / 4, h = (i / 2) % 2, e = i % 2;
        const int row = 16 * warp + lane / 4 + 8 * h, col = 8 * j + 2 * (lane % 4) + e;
        float s = 0.0f;
        for (int k = 0; k < 8; ++k)
            s += emu_tf32_input(emu_fragment_element(op.a, row, k)) *
                 emu_tf32_input(emu_sw128_element(smem, op.db, col, k));
        op.d[i] = op.scale_d ? op.d[i] + s : s;
    }
}
// the register A form: the thread publishes its 4 values (the card reads
// them until the wait retires the product); .sync.aligned: the warpgroup's
// 128 threads issue it together
inline void emu_wgmma_rs(float* d, int n, const float (&a)[4], std::uint64_t db, int scale_d) {
    EmuBlock* eb = emu_block;
    const int wg = threadIdx.x / 128, seq = emu_q.rs_issued++;
    float* slot;
    {
        std::lock_guard<std::mutex> hold(eb->fragments_lock);
        auto& issued = eb->fragments[wg];
        while (static_cast<int>(issued.size()) <= seq) issued.emplace_back();
        slot = issued[seq].data();
    }
    std::memcpy(slot + 4 * (threadIdx.x % 128), a, sizeof(a));
    eb->warpgroups[wg]->arrive_and_wait();
    emu_q.open_mmas.push_back({d, n, db, scale_d, slot});
}
inline void emu_wgmma_commit() {
    emu_q.mmas.push_back(std::move(emu_q.open_mmas));
    emu_q.open_mmas.clear();
}
inline void emu_wgmma_wait(int n, const void* smem) {
    while (static_cast<int>(emu_q.mmas.size()) > n) {
        for (const auto& op : emu_q.mmas.front()) emu_wgmma_run(op, static_cast<const char*>(smem));
        emu_q.mmas.pop_front();
    }
}
inline void emu_check_drained() {
    bool copies = !emu_q.open_copies.empty(), mmas = !emu_q.open_mmas.empty();
    for (const auto& g : emu_q.copies) copies |= !g.empty();
    for (const auto& g : emu_q.mmas) mmas |= !g.empty();
    if (copies) emu_fault("a thread ended with cp.async copies it never waited for");
    if (mmas) emu_fault("a thread ended with wgmma products it never waited for");
}
inline void emu_launch(int grid, int block, const std::function<void()>& body) {
    gridDim.x = grid;
    blockDim.x = block;
    for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        EmuBlock eb;
        eb.all = std::make_unique<std::barrier<>>(block);
        for (int w = 0; w < block / 32; ++w) eb.warps.push_back(std::make_unique<std::barrier<>>(32));
        for (int w = 0; w < block / 128; ++w) eb.warpgroups.push_back(std::make_unique<std::barrier<>>(128));
        eb.fragments.resize(block / 128);
        eb.xchg.assign(block, 0.0f);
        emu_block = &eb;
        std::vector<std::thread> ts;
        for (int t = 0; t < block; ++t) ts.emplace_back([t, &body] { threadIdx.x = t; body(); emu_check_drained(); });
        for (auto& t : ts) t.join();
    }
}
"""

SMEM_FLOATS = 65536  # 256 KB, more than a block may have on the card

# PTX kept in named __device__ functions (csrc/mm3xtf32.cu), each replaced by
# C++ that does what the PTX ISA says, through the runtime above
PTX_FUNCTIONS = {
    "smem_addr": "__device__ __forceinline__ unsigned smem_addr(const void* p) "
                 "{ return emu_shared_address(p, emu_smem); }",
    "cp_async_zfill16": "__device__ __forceinline__ void cp_async_zfill16(float* dst, const float* src, int bytes) "
                        "{ emu_cp_async(dst, src, 16, bytes, emu_smem); }",
    "cp_async_zfill4": "__device__ __forceinline__ void cp_async_zfill4(float* dst, const float* src, int bytes) "
                       "{ emu_cp_async(dst, src, 4, bytes, emu_smem); }",
    "cp_async_commit_group": "__device__ __forceinline__ void cp_async_commit_group() { emu_cp_async_commit(); }",
    "cp_async_wait_group": "template <int N> __device__ __forceinline__ void cp_async_wait_group() "
                           "{ emu_cp_async_wait(N); }",
    "fence_proxy_async": "__device__ __forceinline__ void fence_proxy_async() {}",
    "wgmma_fence": "__device__ __forceinline__ void wgmma_fence() {}",
    "wgmma_commit_group": "__device__ __forceinline__ void wgmma_commit_group() { emu_wgmma_commit(); }",
    "wgmma_wait_group": "template <int N> __device__ __forceinline__ void wgmma_wait_group() "
                        "{ emu_wgmma_wait(N, emu_smem); }",
    "fence_operand": "template <int N> __device__ __forceinline__ void fence_operand(float (&)[N]) {}",
    "wgmma_m64n128k8_tf32_rs": "__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[ACC], float a0, "
                               "float a1, float a2, float a3, uint64_t db, int scale_d) "
                               "{ const float a[4] = {a0, a1, a2, a3}; emu_wgmma_rs(d, 128, a, db, scale_d); }",
}


def replace_functions(text: str, functions: dict) -> str:
    """Each named __device__ function's definition (with its template line)
    replaced by the given C++, where the source defines it."""
    for name, body in functions.items():
        m = re.search(r"(?:template\s*<[^<>]*>\s*)?__device__\s+__forceinline__\s+[\w:<>]+\s+"
                      + name + r"\s*\(", text)
        if m is None:
            continue
        depth, i = 0, text.index("{", m.end())
        while True:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
            i += 1
        text = text[:m.start()] + body + text[i + 1:]
    return text


def rewrite(text: str) -> str:
    """A kernel source or header, rewritten for g++ and the runtime above."""
    text = text.replace("#include <cuda_runtime.h>", '#include "emu_runtime.h"')
    text = replace_functions(text, PTX_FUNCTIONS)
    text = re.sub(r'asm volatile\("cp\.async\.cg.*?\)\);', "std::memcpy(dst, src, 16);", text, flags=re.S)
    text = re.sub(r"const unsigned d = static_cast<unsigned>\(__cvta_generic_to_shared\(dst\)\);", "", text)
    text = re.sub(r"asm volatile\(.*?\);", "", text, flags=re.S)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];", r"float* \1 = emu_smem;", text)
    text = re.sub(r"__shared__ (?:__align__\(\d+\) )?(float \w+\[[^\]]+\];)", r"alignas(16) static \1",
                  text)  # blocks run one at a time
    text = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),[^;]*?>>>\((.*?)\);",
                  r"emu_launch(\2, \3, [&]{ \1(\4); });", text, flags=re.S)
    return re.sub(r"^namespace \{", f"namespace {{\nalignas(1024) float emu_smem[{SMEM_FLOATS}];", text, count=1,
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

    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    plain_entry = lib.gpsat_mm3xtf32_f32
    plain_entry.argtypes = [vp, ll, ll, i, vp, ll, ll, i, vp, i, i, i, i, vp]
    planned = lib.gpsat_mm3xtf32_plan_f32
    planned.argtypes = [vp, ll, ll, i, i, vp, ll, ll, i, i, vp, vp, i, i, i, i, i, vp]
    for fn in (plain_entry, planned, lib.gpsat_mm3xtf32_smem_bytes, lib.emu_faults):
        fn.restype = ctypes.c_int
    ok = check("mm3xtf32 shared memory as planned", lib.gpsat_mm3xtf32_smem_bytes() == MM.SMEM_BYTES <= MM.SMEM_LIMIT,
               kernel=lib.gpsat_mm3xtf32_smem_bytes(), plan=MM.SMEM_BYTES)
    rng = np.random.default_rng(0)

    def operand(shape, tag):
        """A [B, R, C] operand: contiguous, a slice of a wider buffer whose
        padding is NaN (a copy past a row's end poisons the product), or
        one whose base is 4 bytes past a 16-byte boundary."""
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if tag == "sliced":
            wide = torch.full(shape[:2] + (shape[2] + 7,), float("nan"))
            wide[:, :, :shape[2]] = x
            return wide[:, :, :shape[2]]
        if tag == "unaligned":
            wide = torch.zeros(shape[:2] + (shape[2] + 1,))
            wide[:, :, 1:] = x
            return wide[:, :, 1:]
        return x

    # ragged shapes (none a multiple of the 128 x 128 tile or of the K step
    # of 32), every orientation, more than one tile, K ranges of 0 to 10
    # steps and a K that wraps the rings of 4 raw stages and 3 split tiles;
    # each through the entry without a plan and
    # through the planned entry with the plan's load widths, with 4-byte
    # copies only, and cut over K (an empty split among them at K = 100)
    for (batch, M, N, K), ta, tb, tag in [((2, 70, 90, 45), False, False, ""), ((1, 70, 90, 45), True, False, ""),
                                          ((1, 33, 65, 100), False, True, ""), ((2, 17, 129, 9), True, True, ""),
                                          ((2, 70, 90, 45), False, False, "sliced"),
                                          ((1, 130, 257, 300), False, False, ""),
                                          ((1, 130, 140, 300), True, False, "unaligned"),
                                          ((1, 129, 131, 200), False, True, "sliced"),
                                          ((1, 140, 130, 100), True, True, ""), ((1, 60, 200, 90), False, True, ""),
                                          ((1, 130, 60, 150), True, False, "")]:
        x = operand((batch, K, M) if ta else (batch, M, K), tag)
        y = operand((batch, N, K) if tb else (batch, K, N), "")
        ref = MM.mm3xtf32_reference(x, y, ta, tb)
        scale = float(torch.matmul(MM._op(x, ta).abs(), MM._op(y, tb).abs()).max())
        a = (x.data_ptr(), x.stride(1), x.stride(0))
        b = (y.data_ptr(), y.stride(1), y.stride(0))
        p = MM.plan(batch, M, N, K, a, b)
        runs = {"no plan": None, "planned": (p.vec_a, p.vec_b, 1), "4-byte copies": (False, False, 1),
                "3 splits": (p.vec_a, p.vec_b, 3)}
        if K == 100:
            runs["5 splits"] = (p.vec_a, p.vec_b, 5)
        for run, how in runs.items():
            C = torch.full((batch, M, N), float("nan"))  # every element must be written
            if how is None:
                rc = plain_entry(a[0], a[1], a[2], int(ta), b[0], b[1], b[2], int(tb), C.data_ptr(), batch, M, N, K,
                                 None)
            else:
                work = torch.full((how[2], batch, M, N), float("nan"))
                rc = planned(a[0], a[1], a[2], int(ta), int(how[0]), b[0], b[1], b[2], int(tb), int(how[1]),
                             C.data_ptr(), work.data_ptr(), batch, M, N, K, how[2], None)
            if rc != 0:
                raise RuntimeError(f"gpsat_mm3xtf32 refused its input ({run})")
            err = float((C - ref).abs().max()) / scale
            ok &= check(f"mm3xtf32 [{batch}, {M}, {N}, {K}] ta={ta} tb={tb} {tag} {run}".replace("  ", " "),
                        err <= 1e-6 and lib.emu_faults() == 0, max_abs_err_rel=err, faults=lib.emu_faults())
    # an infinity and a NaN in A, an infinity in B (each side's split takes
    # its guarded path): NaN and infinities where the plain version has them.
    # The NaN has the card's bits, 0x7fffffff (the CPU's 0x7fc00000 would
    # survive an unguarded rounding by luck)
    for ta, tb in ((False, False), (True, True)):
        x = operand((1, 40, 70) if ta else (1, 70, 40), "")
        y = operand((1, 90, 40) if tb else (1, 40, 90), "")
        x[0, 3, 5], y[0, 2, 7] = float("inf"), float("-inf")
        x.view(torch.int32)[0, 9, 1] = 0x7fffffff
        ref = MM.mm3xtf32_reference(x, y, ta, tb)
        C = torch.full((1, 70, 90), 7.0)
        if plain_entry(x.data_ptr(), x.stride(1), x.stride(0), int(ta), y.data_ptr(), y.stride(1), y.stride(0),
                       int(tb), C.data_ptr(), 1, 70, 90, 40, None) != 0:
            raise RuntimeError("gpsat_mm3xtf32 refused its input (non-finite)")
        same = torch.equal(torch.isnan(C), torch.isnan(ref)) and torch.equal(torch.isinf(C), torch.isinf(ref))
        fin = torch.isfinite(ref)
        err = float((C[fin] - ref[fin]).abs().max()) / float(torch.matmul(MM._op(x, ta).abs().nan_to_num(0, 0, 0),
                                                                          MM._op(y, tb).abs().nan_to_num(0, 0, 0)).max())
        ok &= check(f"mm3xtf32 non-finite operands ta={ta} tb={tb}", same and err <= 1e-6 and lib.emu_faults() == 0,
                    same_nan_and_inf=same, max_abs_err_rel_finite=err, nan=int(torch.isnan(ref).sum()),
                    inf=int(torch.isinf(ref).sum()))
    x = operand((1, 33, 45), "unaligned")
    refused = planned(x.data_ptr(), x.stride(1), x.stride(0), 0, 1, x.data_ptr(), x.stride(1), x.stride(0), 1, 0,
                      x.data_ptr(), None, 1, 33, 33, 45, 1, None)
    return ok & check("mm3xtf32 refuses 16-byte copies of an unaligned operand", refused != 0, rc=refused)


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
