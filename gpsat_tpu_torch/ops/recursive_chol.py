"""Recursive Cholesky factor pair (L, W = L^-1) in plain PyTorch.

Port of ``gpsat_tpu/ops/recursive_chol.py``. Recursive halving,

    A = [[A11, .], [A21, A22]]
    L11, W11 = facpair(A11)          (recurse)
    L21      = A21 @ W11^T
    S        = A22 - L21 @ L21^T
    L22, W22 = facpair(S)            (recurse)
    W21      = -W22 @ (L21 @ W11)

down to a ``base``-sized block, which is factored right-looking in
rank-``micro`` column steps (a Python loop where the JAX package scans) with
the pivot block factored column by column. The inverse rides the same
recursion, so the pair comes out of one pass with no triangular solves. No
hand-written kernel is involved: this is the JAX package's default route and
the second oracle for the kernels' factor pairs. Works on [..., n, n] of any
float dtype and any n >= 1; a non-positive pivot gives NaN.
"""

from __future__ import annotations

import torch

_BASE = 64
_MICRO = 32


def _mt(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _chol_tiny(A: torch.Tensor) -> torch.Tensor:
    """Right-looking Cholesky of a small [..., n, n] block, one column per
    step on the shrinking trailing block."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        d = torch.sqrt(A[..., 0, 0])
        col = A[..., :, 0] / d[..., None]
        L[..., j:, j] = col
        if j < n - 1:
            t = col[..., 1:]
            A = A[..., 1:, 1:] - t[..., :, None] * t[..., None, :]
    return L


def _chol_base(A: torch.Tensor, micro: int) -> torch.Tensor:
    """Right-looking Cholesky of [..., n, n], n <= base, in rank-``micro``
    column steps; ``micro`` is halved until it divides n, and a ragged or
    tiny block is factored column by column."""
    n = A.shape[-1]
    while micro > 2 and (n <= micro or n % micro):
        micro //= 2
    if n <= micro or n % micro:
        return _chol_tiny(A)
    L = torch.zeros_like(A)
    M = A.clone()
    for j in range(0, n, micro):
        e = j + micro
        Lp = _chol_tiny(M[..., j:e, j:e])
        L[..., j:e, j:e] = Lp
        if e < n:
            Lb = torch.matmul(M[..., e:, j:e], _mt(_tri_inv_rec(Lp)))
            L[..., e:, j:e] = Lb
            M[..., e:, e:] -= torch.matmul(Lb, _mt(Lb))
    return L


def _tri_inv_rec(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular [..., n, n] by recursive halving:
    inv([[A, 0], [C, D]]) = [[A^-1, 0], [-D^-1 C A^-1, D^-1]]."""
    n = L.shape[-1]
    if n == 1:
        return 1.0 / L
    h = n // 2
    W = torch.zeros_like(L)
    Wa = _tri_inv_rec(L[..., :h, :h])
    Wd = _tri_inv_rec(L[..., h:, h:])
    W[..., :h, :h] = Wa
    W[..., h:, h:] = Wd
    W[..., h:, :h] = -torch.matmul(Wd, torch.matmul(L[..., h:, :h], Wa))
    return W


def _facpair(A: torch.Tensor, base: int, micro: int):
    n = A.shape[-1]
    if n <= base:
        L = _chol_base(A, micro)
        return L, _tri_inv_rec(L)
    h = n // 2
    L11, W11 = _facpair(A[..., :h, :h], base, micro)
    L21 = torch.matmul(A[..., h:, :h], _mt(W11))
    L22, W22 = _facpair(A[..., h:, h:] - torch.matmul(L21, _mt(L21)), base, micro)
    L = torch.zeros_like(A)
    W = torch.zeros_like(A)
    L[..., :h, :h], L[..., h:, :h], L[..., h:, h:] = L11, L21, L22
    W[..., :h, :h], W[..., h:, h:] = W11, W22
    W[..., h:, :h] = -torch.matmul(W22, torch.matmul(L21, W11))
    return L, W


def chol_winv_recursive(A: torch.Tensor, base: int = _BASE, micro: int = _MICRO):
    """[..., n, n] SPD -> (L, W = L^-1), both lower-triangular."""
    if A.shape[-1] != A.shape[-2]:
        raise ValueError(f"chol_winv_recursive takes square matrices, got {tuple(A.shape)}")
    return _facpair(A, int(base), int(micro))
