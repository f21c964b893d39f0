"""Masked dense linear algebra for padded expert tiles, batched over B.

Port of ``gpsat_tpu/ops/linalg.py`` for the exact-GPR family. Every tile is
padded to a bucket size N and carries a row-validity mask; padded
rows/columns are neutralised inside the Gram matrix (identity row/col), so
the factor has unit diagonal there, solves give zero on padded rows, and the
LML, predictions and gradients are those of the unpadded problem.

All functions take a leading expert dimension B. Where the JAX package picks
a factor route from environment variables at trace time, these functions take
it as an argument (``factor``) and read no environment variable:

  "block"      64x64 diagonal blocks from ``block_chol.factor_blocks``
  "panel"      128x128 diagonal blocks from ``panel_chol.factor_panels``
  "cholesky"   ``cholesky`` (the blocked kernel) + ``tri_inv_blocked``
  "recursive"  ``recursive_chol.chol_winv_recursive`` (plain PyTorch)

The hand-written kernels take f32 only. On the card a Gram of any other
dtype (f64 above all) leaves the "block" and "panel" routes for ``chol_inv``
(``cholesky_ex`` + ``tri_inv_blocked``), as the JAX package sends every
non-f32 Gram to XLA and as ``ops/cholesky`` does outside its kernel's
domain. A CPU tensor takes the routes' plain versions in any dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gpsat_tpu_torch.ops import kernels as KK
from gpsat_tpu_torch.ops.block_chol import T_BLOCK, factor_blocks
from gpsat_tpu_torch.ops.cholesky import cholesky
from gpsat_tpu_torch.ops.panel_chol import T_PANEL, factor_panels
from gpsat_tpu_torch.ops.recursive_chol import chol_winv_recursive

DEFAULT_JITTER = 1e-6

FACTOR_ROUTES = ("block", "panel", "cholesky", "recursive")
PAIR_ROUTES = ("block", "cholesky", "recursive")


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


def safe_cholesky(K: torch.Tensor, jitter: float = 0.0):
    """Cholesky with optional jitter; returns (L, ok [B]). ok is False where
    the factorisation produced non-finite values."""
    if jitter:
        K = add_diag(K, jitter)
    L = cholesky(K)
    ok = torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)
    return L, ok


def tri_solve(L: torch.Tensor, B: torch.Tensor, *, lower: bool = True, trans: bool = False) -> torch.Tensor:
    """Solve L x = B (or L^T x = B with ``trans``) for triangular L."""
    if trans:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def _assemble_winv(L: torch.Tensor, W: torch.Tensor, T: int) -> torch.Tensor:
    """Fill the off-diagonal blocks of W = L^-1 in place, given its T-sized
    diagonal blocks: W[i,k] = -W[i,i] (sum_j L[i,j] W[j,k]), one block column
    at a time, so each (i, k) is one [T, (i-k)T] x [(i-k)T, T] matmul."""
    Nb = L.shape[-1] // T
    for k in range(Nb):
        ks, ke = k * T, (k + 1) * T
        for i in range(k + 1, Nb):
            is_, ie = i * T, (i + 1) * T
            acc = torch.matmul(L[:, is_:ie, ks:is_], W[:, ks:is_, ks:ke])
            W[:, is_:ie, ks:ke] = -torch.matmul(W[:, is_:ie, is_:ie], acc)
    return W


def _diag_blocks(L: torch.Tensor, T: int) -> torch.Tensor:
    """The T-sized diagonal blocks of [B, N, N], stacked: [B, N/T, T, T]."""
    return torch.stack([L[:, s : s + T, s : s + T] for s in range(0, L.shape[-1], T)], dim=1)


def tri_inv_blocked(L: torch.Tensor, T: int = 64) -> torch.Tensor:
    """W = L^-1 for lower-triangular L [B, N, N], blocked: only the T-sized
    diagonal blocks are solved (one stacked triangular solve), every
    off-diagonal block is a matmul. N that is not a multiple of T is
    identity-padded: inv([[L,0],[0,I]]) = [[L^-1,0],[0,I]]."""
    B, N, _ = L.shape
    eye = torch.eye(min(N, T), dtype=L.dtype, device=L.device)
    if N <= T:
        return tri_solve(L, eye.expand(B, N, N))
    if N % T != 0:
        return tri_inv_blocked(identity_pad(L, T), T=T)[:, :N, :N]
    return tri_inv_from_diag(L, tri_solve(_diag_blocks(L, T), eye.expand(B, N // T, T, T)), T)


def chol_inv(K: torch.Tensor, T: int = 64):
    """(L, W = L^-1) of SPD tiles by ``cholesky`` + ``tri_inv_blocked``."""
    L = cholesky(K)
    return L, tri_inv_blocked(L, T)


def _blocked_cholesky(K: torch.Tensor, T: int, factor_diag):
    """Right-looking blocked Cholesky of [B, N, N], N a multiple of T,
    driven by a diagonal-block factor pair ``factor_diag([B, T, T]) -> (L,
    L^-1)``; the panel scaling and trailing updates are batched matmuls.
    Returns (L [B, N, N], the diagonal blocks' inverses as a list of N/T
    [B, T, T])."""
    B, N, _ = K.shape
    Nb = N // T
    L = K.new_zeros(B, N, N)
    Wdiags = []
    A = K  # trailing matrix
    for p in range(Nb):
        s, e = p * T, (p + 1) * T
        Ld, Di = factor_diag(A[:, :T, :T].contiguous())
        L[:, s:e, s:e] = Ld
        Wdiags.append(Di)
        if p < Nb - 1:
            Lpan = torch.matmul(A[:, T:, :T], Di.transpose(1, 2))  # [B, N - e, T]
            L[:, e:, s:e] = Lpan
            A = A[:, T:, T:] - torch.matmul(Lpan, Lpan.transpose(1, 2))
    return L, Wdiags


def _library_route(K: torch.Tensor) -> bool:
    """A CUDA Gram outside the kernels' dtype: it goes to ``chol_inv``."""
    return K.device.type == "cuda" and K.dtype != torch.float32


def identity_pad(K: torch.Tensor, T: int) -> torch.Tensor:
    """[B, N, N] identity-padded to the next multiple of T (K itself when N
    is one): chol([[K, 0], [0, I]]) = [[L, 0], [0, I]], and likewise for the
    inverse, so the top-left [N, N] slices of either are exact."""
    B, N, _ = K.shape
    pad = (-N) % T
    if pad == 0:
        return K
    Kp = torch.eye(N + pad, dtype=K.dtype, device=K.device).repeat(B, 1, 1)
    Kp[:, :N, :N] = K
    return Kp


def chol_panels_batched(K: torch.Tensor):
    """Blocked Cholesky of [B, N, N] on the 128-block kernel
    (``panel_chol.factor_panels``). Port of ``_chol_panels_batched``.
    Returns (L [B, N, N], Wdiag [B, ceil(N/128), 128, 128]) with Wdiag[:, p]
    = inv(L[:, pT:(p+1)T, pT:(p+1)T]); an N that is not a multiple of 128 is
    identity-padded (``identity_pad``), so the last block's inverse carries
    the pad's identity. A non-f32 CUDA Gram takes ``cholesky`` and one
    triangular solve of the stacked diagonal blocks instead."""
    N = K.shape[-1]
    Kp = identity_pad(K, T_PANEL)
    if _library_route(K):
        L = cholesky(Kp)
        eye = torch.eye(T_PANEL, dtype=K.dtype, device=K.device)
        Wdiag = tri_solve(_diag_blocks(L, T_PANEL), eye.expand(K.shape[0], Kp.shape[-1] // T_PANEL, -1, -1))
    else:
        L, Wdiags = _blocked_cholesky(Kp, T_PANEL, factor_panels)
        Wdiag = torch.stack(Wdiags, dim=1)
    return L[:, :N, :N], Wdiag


def tri_inv_from_diag(L: torch.Tensor, Wdiag: torch.Tensor, T: int = T_PANEL) -> torch.Tensor:
    """W = L^-1 given the diagonal blocks' inverses Wdiag [B, ceil(N/T), T,
    T] (an identity-padded last block for N not a multiple of T)."""
    N = L.shape[-1]
    Lp = identity_pad(L, T)
    W = torch.zeros_like(Lp)
    for i in range(Lp.shape[-1] // T):
        W[:, i * T : (i + 1) * T, i * T : (i + 1) * T] = Wdiag[:, i]
    return _assemble_winv(Lp, W, T)[:, :N, :N]


def tri_solve_from_diag(L: torch.Tensor, Wdiag: torch.Tensor, b: torch.Tensor, T: int = T_PANEL) -> torch.Tensor:
    """Solve L v = b (lower, b [B, N, k]) by block forward substitution with
    the diagonal blocks' inverses: ceil(N/T) steps of matmuls."""
    N = L.shape[-1]
    vs = []
    for p in range(-(-N // T)):
        s, e = p * T, min((p + 1) * T, N)
        rhs = b[:, s:e]
        if p:
            rhs = rhs - torch.matmul(L[:, s:e, :s], torch.cat(vs, dim=1))
        vs.append(torch.matmul(Wdiag[:, p, : e - s, : e - s], rhs))
    return torch.cat(vs, dim=1)


def chol_winv_batched(K: torch.Tensor):
    """Blocked Cholesky and full triangular inverse of [B, N, N] SPD tiles.

    Port of ``_chol_winv_batched``. The 64x64 diagonal blocks (and their
    inverses) come from ``block_chol.factor_blocks``; the panel scaling,
    trailing updates and the block-column W assembly are batched matmuls.
    An N that is not a multiple of 64 is identity-padded (``identity_pad``)
    and sliced back, so the kernel factors every f32 Gram, whatever its
    width. Returns (L, W = L^-1), both [B, N, N]. A non-f32 CUDA Gram takes
    ``chol_inv`` instead.
    """
    if _library_route(K):
        return chol_inv(K, T_BLOCK)
    N = K.shape[-1]
    L, Wdiags = _blocked_cholesky(identity_pad(K, T_BLOCK), T_BLOCK, factor_blocks)
    W = tri_inv_from_diag(L, torch.stack(Wdiags, dim=1), T_BLOCK)
    return L[:, :N, :N], W[:, :N, :N]


def chol_winv_pair(K: torch.Tensor, factor: str = "block"):
    """(L, W = L^-1) of [B, N, N] SPD tiles by the named route; not
    differentiable (see ``chol_winv``)."""
    if factor == "block":
        return chol_winv_batched(K)
    if factor == "recursive":
        return chol_winv_recursive(K)
    if factor == "cholesky":
        return chol_inv(K)
    raise ValueError(f"chol_winv_pair: factor must be one of {PAIR_ROUTES}, got {factor!r}")


class _CholWinv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, factor):
        L, W = chol_winv_pair(K, factor)
        ctx.save_for_backward(L, W)
        return L, W

    @staticmethod
    def backward(ctx, dL, dW):
        L, W = ctx.saved_tensors
        Wt = W.transpose(-1, -2)
        # W = L^-1: dL += -W^T dW W^T. Cotangents above the diagonal are
        # meaningless (both primals are exactly zero there): mask them.
        dLtot = torch.tril(dL - torch.matmul(Wt, torch.matmul(torch.tril(dW), Wt)))
        # Cholesky pullback (Murray 2016) with W in hand: both triangular
        # solves are matmuls
        M = torch.matmul(L.transpose(-1, -2), dLtot)
        Phi = torch.tril(M) - 0.5 * torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))
        dK = torch.matmul(Wt, torch.matmul(Phi, W))
        return 0.5 * (dK + dK.transpose(-1, -2)), None


def chol_winv(K: torch.Tensor, factor: str = "block"):
    """Differentiable (L, W = L^-1) factor pair: ``chol_winv_pair`` with the
    analytic pullback, for consumers whose gradients flow through the
    factorisation (the kernels have no derivative of their own)."""
    return _CholWinv.apply(K, factor)


def chol_winv_padded(K: torch.Tensor, T: int = T_BLOCK, factor: str = "block"):
    """``chol_winv`` of K identity-padded to the next multiple of T
    (``identity_pad``), sliced back. The recursive route takes any N and
    skips the pad. Differentiable."""
    N = K.shape[-1]
    if factor == "recursive" or N % T == 0:
        return chol_winv(K, factor)
    L, W = chol_winv(identity_pad(K, T), factor)
    return L[:, :N, :N], W[:, :N, :N]


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve K x = B given K = L L^T."""
    return tri_solve(L, tri_solve(L, B), trans=True)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def masked_gpr_lml(
    X: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    lengthscales: torch.Tensor,
    kernel_variance: torch.Tensor,
    likelihood_variance: torch.Tensor,
    *,
    kernel: str = "Matern32",
    jitter: float = 0.0,
    fast_inverse: Optional[bool] = None,
) -> torch.Tensor:
    """Log marginal likelihood [B] of exact GPR on padded tiles, with
    gradients by autograd through ``cholesky`` (unlike ops/fused_lml).

    lml = -1/2 y^T K^-1 y - 1/2 log|K| - n/2 log(2 pi),  K = Kf + sigma_n^2 I,
    n = sum(mask). ``fast_inverse`` (default: f32 only) takes the quadratic
    form through W = L^-1 instead of two triangular solves.
    """
    m = mask.to(X.dtype)
    n = m.sum(-1)
    Kf = KK.gram(kernel, X, X, lengthscales, kernel_variance)
    L = cholesky(mask_gram(add_diag(Kf, likelihood_variance + jitter), m))
    ym = (y * m)[:, :, None]
    if X.dtype == torch.float32 if fast_inverse is None else fast_inverse:
        v = torch.matmul(tri_inv_blocked(L), ym)
        quad = torch.sum(v * v, dim=(1, 2))
    else:
        quad = torch.sum(ym * cho_solve(L, ym), dim=(1, 2))
    return -0.5 * quad - 0.5 * logdet_from_chol(L) - 0.5 * n * math.log(2.0 * math.pi)


def profiled_gram(X, mask, lengthscales, tau, *, kernel: str, jitter: float = 0.0):
    """Masked A = k_unit(ls) + (tau + jitter) I [B, N, N] of the profiled
    objective, with m [B, N] and n [B]."""
    m = mask.to(X.dtype)
    k = KK.gram(kernel, X, X, lengthscales, torch.ones_like(tau))
    return mask_gram(add_diag(k, tau + jitter), m), m, m.sum(-1)


def masked_gpr_lml_profiled(
    X: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    lengthscales: torch.Tensor,
    tau: torch.Tensor,
    *,
    kernel: str = "Matern32",
    jitter: float = 0.0,
) -> torch.Tensor:
    """Profiled (kernel variance solved in closed form) LML [B], with
    gradients by autograd through ``cholesky``: the JAX package's form for
    the kernels without a closed-form dK/dtheta (``gpsat_tpu/models/gpr.py::
    neg_lml_profiled``). sigma2_hat = |L^-1 y|^2 / n; an all-masked lane
    gives a finite 0."""
    A, m, n = profiled_gram(X, mask, lengthscales, tau, kernel=kernel, jitter=jitter)
    L = cholesky(A)
    v = tri_solve(L, (y * m)[:, :, None])
    empty = n == 0
    one = torch.ones_like(n)
    sig2 = torch.where(empty, one, torch.sum(v * v, dim=(1, 2)) / torch.clamp_min(n, 1.0))
    lml = -0.5 * n * (1.0 + torch.log(sig2)) - 0.5 * logdet_from_chol(L) - 0.5 * n * math.log(2.0 * math.pi)
    return torch.where(empty, torch.zeros_like(lml), lml)
