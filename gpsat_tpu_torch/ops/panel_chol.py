"""Cholesky factor and inverse of stacked 128x128 SPD blocks.

Port of the Pallas TPU kernel ``gpsat_tpu/ops/pallas/panel_chol.py``
(``_panel_kernel`` via ``factor_panels``). ``factor_panels(Kd)`` maps
[B, 128, 128] SPD blocks to (L, Linv = L^-1):

- a CUDA tensor goes through the hand-written kernel
  ``csrc/panel_chol.cu`` (f32 only), or the call raises;
- a CPU tensor goes through ``factor_panels_reference``, a plain PyTorch
  loop of the kernel's 128 steps that works in any float dtype.

The pivot is ``sqrt(max(a_kk, 1e-30))`` and the column is scaled by its
reciprocal: a zero pivot gives finite values (an all-zero block gives
L = 1e-15 I, Linv = 1e15 I). That clamp is the whole contract: a block with
negative pivots still overflows to inf and NaN. Strict upper triangles are
zero on output.

The kernel library is built and loaded by ``ops/_build.py`` at first use.
Each successful kernel launch adds one to ``factor_panels.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from gpsat_tpu_torch.ops import _build

T_PANEL = 128
PIVOT_FLOOR = 1e-30
_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"gpsat_panel128_f32": [_VP, _VP, _VP, _INT, _VP]}


def factor_panels_reference(Kd: torch.Tensor):
    """Plain PyTorch version of the kernel: the same 128 right-looking steps
    (clamped pivot, column scale, rank-1 trailing update, forward-substitution
    row of the inverse) on [B, T, T] blocks of any float dtype."""
    B, T, t = Kd.shape
    if t != T:
        raise ValueError(f"blocks must be square, got {tuple(Kd.shape)}")
    A = Kd.clone()
    W = torch.zeros_like(Kd)
    eye = torch.eye(T, dtype=Kd.dtype, device=Kd.device)
    for k in range(T):
        d = torch.sqrt(torch.clamp_min(A[:, k, k], PIVOT_FLOOR))
        dinv = 1.0 / d
        A[:, k, k] = d
        A[:, k + 1 :, k] *= dinv[:, None]
        col = A[:, k + 1 :, k]
        # the full trailing square is updated; only its lower triangle is read
        A[:, k + 1 :, k + 1 :] -= col[:, :, None] * col[:, None, :]
        acc = torch.einsum("bk,bkc->bc", A[:, k, :k], W[:, :k, :])
        W[:, k, :] = (eye[k] - acc) * dinv[:, None]
    return torch.tril(A), torch.tril(W)


def factor_panels(Kd: torch.Tensor):
    """[B, 128, 128] stacked SPD blocks -> (L, Linv), both [B, 128, 128].

    CUDA tensors launch the hand-written kernel (f32, contiguous) and raise
    on anything it does not take; CPU tensors run the plain version."""
    shape_ok = Kd.ndim == 3 and Kd.shape[1:] == (T_PANEL, T_PANEL)
    if _build.check_kernel_input("factor_panels", Kd, shape_ok, f"[B, {T_PANEL}, {T_PANEL}]"):
        return factor_panels_reference(Kd)
    B = Kd.shape[0]
    L = torch.empty_like(Kd)
    Linv = torch.empty_like(Kd)
    if B == 0:
        return L, Linv
    lib = _build.load_library("panel_chol", _SYMBOLS)
    _build.launch("panel_chol", lib.gpsat_panel128_f32, Kd, Kd.data_ptr(), L.data_ptr(), Linv.data_ptr(), B)
    factor_panels.launches += 1
    return L, Linv


factor_panels.launches = 0
