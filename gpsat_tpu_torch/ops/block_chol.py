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

The kernel library is built and loaded by ``ops/_build.py`` at first use.
Each successful kernel launch adds one to ``factor_blocks.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from gpsat_tpu_torch.ops import _build

T_BLOCK = 64
_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"gpsat_cholinv64_f32": [_VP, _VP, _VP, _INT, _VP]}


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
    shape_ok = Kd.ndim == 3 and Kd.shape[1:] == (T_BLOCK, T_BLOCK)
    if _build.check_kernel_input("factor_blocks", Kd, shape_ok, f"[B, {T_BLOCK}, {T_BLOCK}]"):
        return factor_blocks_reference(Kd)
    B = Kd.shape[0]
    L = torch.empty_like(Kd)
    W = torch.empty_like(Kd)
    if B == 0:
        return L, W
    lib = _build.load_library("block_chol", _SYMBOLS)
    _build.launch("block_chol", lib.gpsat_cholinv64_f32, Kd, Kd.data_ptr(), L.data_ptr(), W.data_ptr(), B)
    factor_blocks.launches += 1
    return L, W


factor_blocks.launches = 0
