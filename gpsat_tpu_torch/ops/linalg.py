"""Masked dense linear algebra for padded expert tiles, batched over B.

Port of the part of ``gpsat_tpu/ops/linalg.py`` on the exact-GPR main path.
Every tile is padded to a bucket size N and carries a row-validity mask;
padded rows/columns are neutralised inside the Gram matrix (identity
row/col), so the factor has unit diagonal there, solves give zero on padded
rows, and the LML, predictions and gradients are those of the unpadded
problem.
"""

from __future__ import annotations

import torch

from gpsat_tpu_torch.ops.block_chol import T_BLOCK, factor_blocks


def mask_gram(K: torch.Tensor, mask: torch.Tensor, diag_value: float = 1.0) -> torch.Tensor:
    """Zero padded rows/cols of K [B, N, N] and put ``diag_value`` on the
    padded diagonal. mask: [B, N] (1.0 valid / 0.0 padded)."""
    m = mask.to(K.dtype)
    Km = K * (m[:, :, None] * m[:, None, :])
    return Km + torch.diag_embed((1.0 - m) * diag_value)


def add_diag(K: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """K [B, N, N] + value [B] (or a scalar) on every diagonal entry."""
    value = torch.as_tensor(value, dtype=K.dtype, device=K.device)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + value.reshape(-1, 1, 1) * eye


def chol_winv_batched(K: torch.Tensor):
    """Blocked Cholesky and full triangular inverse of [B, N, N] SPD tiles.

    Port of ``_chol_winv_batched``. The 64x64 diagonal blocks (and their
    inverses) come from ``block_chol.factor_blocks``; the panel scaling,
    trailing updates and the block-column W assembly are batched matmuls.
    Returns (L, W = L^-1), both [B, N, N], written into preallocated
    tensors.
    """
    T = T_BLOCK
    B, N, _ = K.shape
    if N % T != 0:
        raise ValueError(f"N={N} is not a multiple of the {T}-row block")
    Nb = N // T
    L = K.new_zeros(B, N, N)
    W = K.new_zeros(B, N, N)

    A = K  # trailing matrix
    for p in range(Nb):
        s, e = p * T, (p + 1) * T
        Ld, Di = factor_blocks(A[:, :T, :T].contiguous())
        L[:, s:e, s:e] = Ld
        W[:, s:e, s:e] = Di
        if p < Nb - 1:
            Lpan = torch.matmul(A[:, T:, :T], Di.transpose(1, 2))  # [B, N - e, T]
            L[:, e:, s:e] = Lpan
            A = A[:, T:, T:] - torch.matmul(Lpan, Lpan.transpose(1, 2))

    # W assembly, one block column at a time: row-block i of column k needs
    # W rows k..i-1 of the same column, one [T, (i-k)T] x [(i-k)T, T] matmul
    for k in range(Nb):
        ks, ke = k * T, (k + 1) * T
        for i in range(k + 1, Nb):
            is_, ie = i * T, (i + 1) * T
            acc = torch.matmul(L[:, is_:ie, ks:is_], W[:, ks:is_, ks:ke])
            W[:, is_:ie, ks:ke] = -torch.matmul(W[:, is_:ie, is_:ie], acc)
    return L, W
