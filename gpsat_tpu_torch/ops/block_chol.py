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

The kernel is blocked (2x2 blocks of 32: the one-warp 32x32 factor and
inverse of ``csrc/factor128.cuh`` on each diagonal block, tile products for
the rest). ``factor_blocks_blocked_emulation`` runs that same order in plain
PyTorch, for the tests only; ``factor_blocks_reference`` stays the contract.

The kernel library is built and loaded by ``ops/_build.py`` at first use.
Each successful kernel launch adds one to ``factor_blocks.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from gpsat_tpu_torch.ops import _build
from gpsat_tpu_torch.ops.panel_chol import factor_panels_blocked_emulation

T_BLOCK = 64
NB = 32  # the kernel's diagonal-step side
_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {
    "gpsat_cholinv64_f32": [_VP, _VP, _VP, _INT, _VP],
    "gpsat_cholinv64_blocks_per_sm": [ctypes.POINTER(_INT)],
}


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


def factor_blocks_blocked_emulation(Kd: torch.Tensor):
    """The CUDA kernel's order in plain PyTorch (tests only), on [B, 64, 64]
    blocks of any float dtype: factor and invert the diagonal block (0,0)
    with the rsqrt pivot (r = rsqrt(a_jj), d = a_jj r, the column scaled by
    r and row j of W by 1/d: NaN for a non-positive pivot); L10 = A10 W00^T;
    A11 -= L10 L10^T; factor and invert (1,1); M = W11 L10; W10 = -M W00.
    That is kernel 3's blocked 128-factor order at two blocks of 32."""
    if Kd.ndim != 3 or Kd.shape[1:] != (T_BLOCK, T_BLOCK):
        raise ValueError(f"takes [B, {T_BLOCK}, {T_BLOCK}], got {tuple(Kd.shape)}")
    return factor_panels_blocked_emulation(Kd, nb=NB, pivot="rsqrt")


def blocks_per_sm() -> int:
    """How many of the kernel's thread blocks one SM of the current card
    holds at once (the CUDA occupancy query; needs a card)."""
    lib = _build.load_library("block_chol", _SYMBOLS)
    n = ctypes.c_int(0)
    err = lib.gpsat_cholinv64_blocks_per_sm(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"block_chol occupancy query failed: cudaError {err}")
    return n.value


def factor_blocks(Kd: torch.Tensor):
    """[B, 64, 64] stacked SPD blocks -> (L, W = L^-1), both [B, 64, 64].

    CUDA tensors launch the hand-written kernel (f32, contiguous, 16-byte
    aligned) and raise on anything it does not take; CPU tensors run the
    plain version."""
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
    _build.count_launch(factor_blocks)
    return L, W


factor_blocks.launches = 0
