"""Fused Cholesky + inverse of stacked 64x64 SPD blocks.

Port of the Pallas TPU kernel ``gpsat_tpu/ops/pallas/block_chol.py``
(``_cholinv_kernel`` via ``factor_blocks``). ``factor_blocks(Kd)`` maps
[B, 64, 64] SPD blocks to (L, W = L^-1):

- a CUDA tensor goes through the hand-written kernel
  ``csrc/block_chol.cu`` (f32 only), or the call raises;
- a CPU tensor goes through ``factor_blocks_reference``, a plain PyTorch
  loop of the kernel's 64 steps that works in any float dtype.

A non-positive pivot gives NaN in both outputs (no clamping): downstream
finite-checks rely on it. Strict upper triangles are zero on output.

The kernel library is compiled with ``nvcc`` for ``sm_90a`` at first use,
into ``gpsat_tpu_torch/build/`` (listed in ``.gitignore``), and loaded with
ctypes. Each successful kernel launch adds one to ``factor_blocks.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

T_BLOCK = 64

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "block_chol.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v"]

_lib = None


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return nvcc


def build_library() -> Path:
    """Compile csrc/block_chol.cu into the build directory (once per source
    content) and return the library path. ``nvcc``'s resource report
    (``-Xptxas -v``) is kept beside it as ``<library>.log``."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libblock_chol_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    Path(str(lib_path) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent builder never sees a partial file
    return lib_path


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.gpsat_cholinv64_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def factor_blocks_reference(Kd: torch.Tensor):
    """Plain PyTorch version of the kernel: the same 64 right-looking steps
    (pivot, column scale, rank-1 trailing update, forward-substitution row
    of W) on [B, T, T] blocks of any float dtype."""
    B, T, t = Kd.shape
    if t != T:
        raise ValueError(f"blocks must be square, got {tuple(Kd.shape)}")
    A = Kd.clone()
    W = torch.zeros_like(Kd)
    eye = torch.eye(T, dtype=Kd.dtype, device=Kd.device)
    for j in range(T):
        d = torch.rsqrt(A[:, j, j])  # NaN for a non-positive pivot
        A[:, j:, j] *= d[:, None]
        col = A[:, j + 1 :, j]
        # the full trailing square is updated; only its lower triangle is read
        A[:, j + 1 :, j + 1 :] -= col[:, :, None] * col[:, None, :]
        acc = torch.einsum("bk,bkc->bc", A[:, j, :j], W[:, :j, :])
        W[:, j, :] = (eye[j] - acc) * d[:, None]
    return torch.tril(A), torch.tril(W)


def factor_blocks(Kd: torch.Tensor):
    """[B, 64, 64] stacked SPD blocks -> (L, W = L^-1), both [B, 64, 64].

    CUDA tensors launch the hand-written kernel (f32, contiguous) and raise
    on anything it does not take; CPU tensors run the plain version."""
    if Kd.ndim != 3 or Kd.shape[1:] != (T_BLOCK, T_BLOCK):
        raise ValueError(f"factor_blocks takes [B, {T_BLOCK}, {T_BLOCK}], got {tuple(Kd.shape)}")
    if Kd.device.type == "cpu":
        return factor_blocks_reference(Kd)
    if Kd.device.type != "cuda":
        raise ValueError(f"factor_blocks: unsupported device {Kd.device}")
    if Kd.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 only, got {Kd.dtype}")
    if not Kd.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous tensor")
    B = Kd.shape[0]
    if B > 2**31 - 1:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit")
    L = torch.empty_like(Kd)
    W = torch.empty_like(Kd)
    if B == 0:
        return L, W
    lib = _load_lib()
    with torch.cuda.device(Kd.device):
        stream = torch.cuda.current_stream(Kd.device).cuda_stream
        err = lib.gpsat_cholinv64_f32(Kd.data_ptr(), L.data_ptr(), W.data_ptr(), B, stream)
    if err != 0:
        raise RuntimeError(f"block_chol kernel launch failed: cudaError {err}")
    factor_blocks.launches += 1
    return L, W


factor_blocks.launches = 0
