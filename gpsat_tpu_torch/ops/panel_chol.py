"""Cholesky factor and inverse of stacked 128x128 SPD blocks.

Port of the Pallas TPU kernel ``gpsat_tpu/ops/pallas/panel_chol.py``
(``_panel_kernel`` via ``factor_panels``). ``factor_panels(Kd)`` maps
[B, 128, 128] SPD blocks to (L, Linv = L^-1):

- a CUDA tensor goes through the hand-written kernel
  ``csrc/panel_chol.cu`` (f32 only), or the call raises;
- a CPU tensor goes through ``factor_panels_reference``, a plain PyTorch
  loop of 128 right-looking steps that works in any float dtype: the
  contract both are held to.

The kernel is blocked (four panels of 32 columns, the inverse assembled by
sub-diagonals of 32x32 blocks; the device code is ``csrc/factor128.cuh``,
which kernel 3 shares). ``factor_panels_blocked_emulation`` runs that same
order in plain PyTorch, for the tests only.

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
NB = 32  # the kernel's panel width
PIVOT_FLOOR = 1e-30
_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {
    "gpsat_panel128_f32": [_VP, _VP, _VP, _INT, _VP],
    "gpsat_panel128_blocks_per_sm": [ctypes.POINTER(_INT)],
}


def factor_panels_reference(Kd: torch.Tensor):
    """Plain PyTorch version of the kernel and its contract: 128 right-looking
    steps (clamped pivot, column scale, rank-1 trailing update,
    forward-substitution row of the inverse) on [B, T, T] blocks of any float
    dtype."""
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


def _diag_factor_inverse(A: torch.Tensor, pivot: str):
    """The kernel's diagonal step on [B, nb, nb]: nb right-looking steps and
    the inverse by forward elimination in the same sweep (row j of W scaled,
    then subtracted from the rows below). ``pivot`` "clamp" is kernel 2's
    rule, d = sqrt(max(a_jj, 1e-30)) with both scales 1/d; "rsqrt" is kernel
    3's, r = rsqrt(a_jj), d = a_jj r, the column scaled by r and row j of W by
    1/d (NaN for a non-positive pivot)."""
    A = A.clone()
    B, nb, _ = A.shape
    W = torch.eye(nb, dtype=A.dtype, device=A.device).expand(B, nb, nb).clone()
    for j in range(nb):
        if pivot == "clamp":
            d = torch.sqrt(torch.clamp_min(A[:, j, j], PIVOT_FLOOR))
            colscale = wscale = 1.0 / d
        else:
            colscale = torch.rsqrt(A[:, j, j])
            d = A[:, j, j] * colscale
            wscale = 1.0 / d
        A[:, j, j] = d
        A[:, j + 1 :, j] *= colscale[:, None]
        W[:, j, : j + 1] *= wscale[:, None]
        col = A[:, j + 1 :, j]
        A[:, j + 1 :, j + 1 :] -= col[:, :, None] * col[:, None, :]
        W[:, j + 1 :, : j + 1] -= col[:, :, None] * W[:, j, None, : j + 1]
    return torch.tril(A), W


def factor_panels_blocked_emulation(Kd: torch.Tensor, nb: int = NB, pivot: str = "clamp"):
    """The CUDA kernel's blocked order in plain PyTorch (tests only), on
    [B, T, T] blocks with T a multiple of ``nb``, with the pivot rule of
    kernel 2 ("clamp") or of kernel 3 ("rsqrt", see ``_diag_factor_inverse``;
    csrc/factor128.cuh holds the code both kernels share):

    1. per panel k: the diagonal block's factor and inverse W_kk;
       L21 = A21 W_kk^T; A22 -= L21 L21^T (only its lower blocks are read);
    2. M_IK = W_II L_IK for I > K, then W_IJ = -sum_{K=J}^{I-1} M_IK W_KJ,
       one sub-diagonal d = I - J at a time.
    """
    B, T, t = Kd.shape
    if t != T or T % nb:
        raise ValueError(f"blocks must be square with a side that is a multiple of {nb}, got {tuple(Kd.shape)}")
    if pivot not in ("clamp", "rsqrt"):
        raise ValueError(f"pivot must be 'clamp' or 'rsqrt', got {pivot!r}")
    nk = T // nb
    A = Kd.clone()
    Wd = []
    for k in range(nk):
        s, r = slice(k * nb, (k + 1) * nb), slice((k + 1) * nb, T)
        Lkk, Wkk = _diag_factor_inverse(A[:, s, s], pivot)
        A[:, s, s] = Lkk
        Wd.append(Wkk)
        if k + 1 < nk:
            L21 = torch.matmul(A[:, r, s], Wkk.transpose(1, 2))
            A[:, r, s] = L21
            A[:, r, r] -= torch.matmul(L21, L21.transpose(1, 2))
    L = torch.tril(A)

    def blk(X, I, J):
        return X[:, I * nb : (I + 1) * nb, J * nb : (J + 1) * nb]

    W = torch.zeros_like(Kd)
    for I in range(nk):
        blk(W, I, I).copy_(Wd[I])
    M = {(I, K): torch.matmul(Wd[I], blk(L, I, K)) for I in range(nk) for K in range(I)}
    for d in range(1, nk):
        for J in range(nk - d):
            I = J + d
            blk(W, I, J).copy_(-sum(torch.matmul(M[I, K], blk(W, K, J)) for K in range(J, I)))
    return L, W


def blocks_per_sm() -> int:
    """How many of the kernel's thread blocks one SM of the current card
    holds at once (the CUDA occupancy query; needs a card)."""
    lib = _build.load_library("panel_chol", _SYMBOLS)
    n = ctypes.c_int(0)
    err = lib.gpsat_panel128_blocks_per_sm(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"panel_chol occupancy query failed: cudaError {err}")
    return n.value


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
    _build.count_launch(factor_panels)
    return L, Linv


factor_panels.launches = 0
