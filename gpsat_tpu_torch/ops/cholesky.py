"""Batched lower Cholesky factor with a hand-written blocked CUDA kernel.

Port of ``gpsat_tpu/ops/pallas/cholesky.py`` (``_chol_kernel`` via
``_pallas_chol_batched``, entry ``cholesky``). ``cholesky(K)`` takes
[B, N, N] (or [N, N]) and returns the lower factor. The dispatch is explicit:

- f32 with N a multiple of 128 and N <= 1024 is the kernel's domain: a CUDA
  tensor goes through ``csrc/cholesky.cu`` or the call raises; a CPU tensor
  goes through ``cholesky_reference``, the plain PyTorch loop of the same
  blocked algorithm;
- every other dtype or shape goes to ``torch.linalg.cholesky_ex``, with NaN
  written over each matrix whose factorisation failed (``safe_cholesky``'s
  ok-flag reads that, and one bad matrix must not raise for the whole batch).

Inside the kernel's domain a non-positive pivot gives NaN in that matrix only
(rsqrt pivot, no clamp). Strict upper triangles are zero on output.

``cholesky`` is differentiable: the backward is the standard Cholesky
pullback (Murray 2016) in plain PyTorch with two triangular solves, as in the
JAX package, which has no backward kernel either.

The kernel is blocked for the card: per 128-block step a diagonal kernel
(the blocked 128-factor of ``csrc/factor128.cuh``, which kernel 2 shares,
with this contract's pivot, then the panel) and a trailing kernel.
``cholesky_blocked_emulation`` runs that same order in plain PyTorch, for
the tests only.

The kernel library is built and loaded by ``ops/_build.py`` at first use.
One call of the kernel's host entry launches several ``__global__``
functions on the caller's stream (see the source) and adds one to
``cholesky.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from gpsat_tpu_torch.ops import _build
from gpsat_tpu_torch.ops.panel_chol import NB, factor_panels_blocked_emulation

BLOCK = 128
MAX_N = 1024
_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {
    "gpsat_cholesky_f32": [_VP, _VP, _INT, _INT, _VP],
    "gpsat_cholesky_blocks_per_sm": [ctypes.POINTER(_INT), ctypes.POINTER(_INT)],
}


def in_kernel_domain(K: torch.Tensor) -> bool:
    """f32, N a multiple of 128, N <= 1024: what the kernel (and, on the CPU,
    its plain version) takes."""
    N = K.shape[-1]
    return K.dtype == torch.float32 and N % BLOCK == 0 and 0 < N <= MAX_N


def _unblocked_chol_block(A: torch.Tensor) -> torch.Tensor:
    """[B, T, T] -> lower factor by T rank-1 steps with an rsqrt pivot (NaN
    for a non-positive one)."""
    T = A.shape[-1]
    A = A.clone()
    for j in range(T):
        d = torch.rsqrt(A[:, j, j])
        A[:, j:, j] *= d[:, None]
        col = A[:, j + 1 :, j]
        A[:, j + 1 :, j + 1 :] -= col[:, :, None] * col[:, None, :]
    return torch.tril(A)


def _tri_inv_block(L: torch.Tensor) -> torch.Tensor:
    """Inverse of [B, T, T] lower-triangular blocks by forward substitution,
    row i = (e_i - L[i, :i] W[:i, :]) / L[i, i]."""
    T = L.shape[-1]
    W = torch.zeros_like(L)
    eye = torch.eye(T, dtype=L.dtype, device=L.device)
    for i in range(T):
        acc = torch.einsum("bk,bkc->bc", L[:, i, :i], W[:, :i, :])
        W[:, i, :] = (eye[i] - acc) / L[:, i, i, None]
    return W


def cholesky_reference(K: torch.Tensor, T: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch version of the kernel on [B, N, N], N a multiple of T:
    per block step the unblocked factor of the diagonal block, its inverse,
    panel = A21 W^T, trailing -= panel panel^T; any float dtype."""
    B, N, n = K.shape
    if n != N or N % T != 0:
        raise ValueError(f"cholesky_reference takes [B, N, N] with N a multiple of {T}, got {tuple(K.shape)}")
    out = K.clone()
    for k in range(0, N, T):
        e = k + T
        Lkk = _unblocked_chol_block(out[:, k:e, k:e])
        out[:, k:e, k:e] = Lkk
        if e < N:
            panel = torch.matmul(out[:, e:, k:e], _tri_inv_block(Lkk).transpose(1, 2))
            out[:, e:, k:e] = panel
            out[:, e:, e:] -= torch.matmul(panel, panel.transpose(1, 2))
    return torch.tril(out)


def cholesky_blocked_emulation(K: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's order of operations in plain PyTorch (tests only), on
    [B, N, N] with N a multiple of 128, per 128-block step:

    1. the diagonal block's factor and inverse W by the blocked 128-factor
       (``factor_panels_blocked_emulation`` with the rsqrt pivot);
    2. the panel by 32x32 blocks over W's lower blocks only,
       L_sJ = sum_{K<=J} A_sK W_JK^T;
    3. the trailing matrix minus the panel times its transpose.
    """
    B, N, n = K.shape
    if n != N or N % BLOCK != 0:
        raise ValueError(f"cholesky_blocked_emulation takes [B, N, N], N a multiple of {BLOCK}, got {tuple(K.shape)}")
    out = K.clone()
    for k in range(0, N, BLOCK):
        e = k + BLOCK
        Lkk, Wkk = factor_panels_blocked_emulation(out[:, k:e, k:e], pivot="rsqrt")
        out[:, k:e, k:e] = Lkk
        if e < N:
            A21 = out[:, e:, k:e]
            panel = torch.zeros_like(A21)
            for J in range(0, BLOCK, NB):
                for Kb in range(0, J + NB, NB):
                    WJK = Wkk[:, J : J + NB, Kb : Kb + NB]
                    panel[:, :, J : J + NB] += torch.matmul(A21[:, :, Kb : Kb + NB], WJK.transpose(1, 2))
            out[:, e:, k:e] = panel
            out[:, e:, e:] -= torch.matmul(panel, panel.transpose(1, 2))
    return torch.tril(out)


def blocks_per_sm() -> dict:
    """How many thread blocks of the diagonal kernel and of the trailing kernel
    one SM of the current card holds at once (the CUDA occupancy query; needs
    a card)."""
    lib = _build.load_library("cholesky", _SYMBOLS)
    diag, trailing = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.gpsat_cholesky_blocks_per_sm(ctypes.byref(diag), ctypes.byref(trailing))
    if err != 0:
        raise RuntimeError(f"cholesky occupancy query failed: cudaError {err}")
    return {"chol_diag_kernel": diag.value, "chol_trailing_kernel": trailing.value}


def _kernel(K: torch.Tensor) -> torch.Tensor:
    """[B, N, N] f32 CUDA tensor inside the kernel's domain -> L."""
    if not K.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous tensor")
    if K.data_ptr() % 16 != 0:
        raise ValueError("the CUDA kernel takes a 16-byte aligned tensor")
    B, N, _ = K.shape
    L = torch.empty_like(K)
    if B == 0:
        return L
    lib = _build.load_library("cholesky", _SYMBOLS)
    _build.launch("cholesky", lib.gpsat_cholesky_f32, K, K.data_ptr(), L.data_ptr(), B, N)
    _build.count_launch(cholesky)
    return L


def _factor(K: torch.Tensor) -> torch.Tensor:
    if K.ndim not in (2, 3) or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"cholesky takes [B, N, N] or [N, N], got {tuple(K.shape)}")
    if K.ndim == 2:
        return _factor(K[None])[0]
    if in_kernel_domain(K):
        if K.device.type == "cuda":
            return _kernel(K)
        if K.device.type == "cpu":
            return cholesky_reference(K)
        raise ValueError(f"cholesky: unsupported device {K.device}")
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info > 0)[:, None, None], torch.full_like(L, float("nan")), L)


def _chol_bwd(L: torch.Tensor, dL: torch.Tensor) -> torch.Tensor:
    """Cholesky pullback: dK = sym(L^-T Phi(L^T dL) L^-1), Phi = lower
    triangle with the diagonal halved (Murray 2016, eq. 12)."""
    Lt = L.transpose(-1, -2)
    M = torch.matmul(Lt, dL)
    P = torch.tril(M) - 0.5 * torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))
    X = torch.linalg.solve_triangular(Lt, P, upper=True)  # L^-T P
    dK = torch.linalg.solve_triangular(Lt, X.transpose(-1, -2), upper=True).transpose(-1, -2)  # X L^-1
    return 0.5 * (dK + dK.transpose(-1, -2))


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K):
        L = _factor(K)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, dL):
        (L,) = ctx.saved_tensors
        return _chol_bwd(L, dL)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of [B, N, N] or [N, N], differentiable."""
    return _Cholesky.apply(K)


cholesky.launches = 0
