"""Masked GPR log marginal likelihood with analytic gradients, batched.

Port of ``gpsat_tpu/ops/fused_lml.py``: ``masked_gpr_lml_fused`` with its
four factor routes, and ``masked_gpr_lml_profiled`` / ``profiled_sigma2``
(the kernel variance solved in closed form). Autodiff through the
factorisation would cost another factorisation's worth of sequential work;
the analytic form (Rasmussen & Williams eq. 5.9) needs only

  forward:  K -> (L, W = L^-1), Kinv = W^T W, alpha = Kinv y, lml
  backward: dlml/dtheta = 0.5 sum(G * dK/dtheta),  G = alpha alpha^T - Kinv

with dK/dtheta in closed form per kernel: matmuls and elementwise work. The
expert batch is the leading dimension B. The factor route is the ``factor``
argument (the JAX package reads environment variables for it):

  "block"      ops/linalg.chol_winv_batched: 64-blocks from the block kernel
  "panel"      ops/linalg.chol_panels_batched: 128-blocks from the panel
               kernel, then block solves and W from their inverses
  "cholesky"   ops/linalg.cholesky (the blocked kernel) + tri_inv_blocked
  "recursive"  ops/recursive_chol.chol_winv_recursive, plain PyTorch
"""

from __future__ import annotations

import math

import torch

from gpsat_tpu_torch.ops import kernels as KK
from gpsat_tpu_torch.ops import linalg as LA

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979
_R_FLOOR = 1e-36  # same r^2 floor as ops.kernels so values agree exactly
# the kernels with a closed-form dK/dtheta here; the others take the
# autodiff LML (ops/linalg.masked_gpr_lml)
FUSED_KERNELS = ("Matern12", "Exponential", "Matern32", "Matern52", "RBF", "SquaredExponential")


def _kernel_and_r(kernel: str, X, lengthscales, kernel_variance):
    """k(X, X) [B, N, N] and r [B, N, N]; kernel_variance [B]."""
    r2 = KK.scaled_squared_dist(X, X, lengthscales)
    r = torch.sqrt(torch.clamp_min(r2, _R_FLOOR))
    kv = kernel_variance[:, None, None]
    if kernel in ("RBF", "SquaredExponential"):
        k = kv * torch.exp(-0.5 * r2)
    elif kernel in ("Matern12", "Exponential"):
        k = kv * torch.exp(-r)
    elif kernel == "Matern32":
        k = kv * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)
    elif kernel == "Matern52":
        k = kv * (1.0 + _SQRT5 * r + 5.0 / 3.0 * r2) * torch.exp(-_SQRT5 * r)
    else:
        raise NotImplementedError(f"fused LML supports {FUSED_KERNELS}, got {kernel!r}")
    return k, r


def _dk_dl_factor(kernel: str, r, kernel_variance):
    """phi(r) such that dk/dl_d = phi(r) * Delta_d^2 / l_d^3 (elementwise)."""
    kv = kernel_variance[:, None, None]
    if kernel in ("RBF", "SquaredExponential"):
        return kv * torch.exp(-0.5 * r * r)
    if kernel in ("Matern12", "Exponential"):
        return kv * torch.exp(-r) / r
    if kernel == "Matern32":
        return 3.0 * kv * torch.exp(-_SQRT3 * r)
    if kernel == "Matern52":
        return (5.0 / 3.0) * kv * (1.0 + _SQRT5 * r) * torch.exp(-_SQRT5 * r)
    raise NotImplementedError(f"fused LML supports {FUSED_KERNELS}, got {kernel!r}")


def _factor_terms(factor: str, Km, ym):
    """(quad = y^T K^-1 y [B], logdet [B], Kinv [B, N, N], alpha [B, N, 1])
    of the masked Gram Km by the named factor route."""
    if factor == "block":
        L, W = LA.chol_winv_batched(Km)
        v = torch.matmul(W, ym)
    elif factor == "panel":
        L, Wdiag = LA.chol_panels_batched(Km)
        v = LA.tri_solve_from_diag(L, Wdiag, ym)
        W = LA.tri_inv_from_diag(L, Wdiag)
    elif factor == "cholesky":
        L = LA.cholesky(Km)
        W = LA.tri_inv_blocked(L)
        v = None
    elif factor == "recursive":
        L, W = LA.chol_winv_recursive(Km)
        v = None
    else:
        raise ValueError(f"factor must be one of {LA.FACTOR_ROUTES}, got {factor!r}")
    logdet = LA.logdet_from_chol(L)
    del L
    Kinv = torch.matmul(W.transpose(1, 2), W)
    alpha = torch.matmul(Kinv, ym)
    # the routes that do not solve for v reuse alpha: quad = y . K^-1 y
    quad = torch.sum(ym * alpha, dim=(1, 2)) if v is None else torch.sum(v * v, dim=(1, 2))
    return quad, logdet, Kinv, alpha


def _lengthscale_grads(Gphi, X, lengthscales):
    """0.5 sum(Gphi * Delta_d^2) / l_d^3 for every input dimension d: [B, D]."""
    return torch.stack(
        [
            0.5 * torch.sum(Gphi * (X[:, :, d, None] - X[:, None, :, d]) ** 2, dim=(1, 2)) / lengthscales[:, d] ** 3
            for d in range(X.shape[-1])
        ],
        dim=-1,
    )


class _MaskedGPRLMLFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, X, y, mask, lengthscales, kernel_variance, likelihood_variance, jitter, factor):
        m = mask.to(X.dtype)
        n = m.sum(-1)
        k, r = _kernel_and_r(kernel, X, lengthscales, kernel_variance)
        Km = LA.mask_gram(LA.add_diag(k, likelihood_variance + jitter), m)
        del k
        ym = (y * m)[:, :, None]
        quad, logdet, Kinv, alpha = _factor_terms(factor, Km, ym)
        del Km
        lml = -0.5 * quad - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)
        ctx.kernel = kernel
        ctx.save_for_backward(X, m, lengthscales, kernel_variance, r, Kinv, alpha[:, :, 0])
        return lml

    @staticmethod
    def backward(ctx, g):
        X, m, lengthscales, kernel_variance, r, Kinv, alpha = ctx.saved_tensors
        kernel = ctx.kernel
        G = (alpha[:, :, None] * alpha[:, None, :] - Kinv) * (m[:, :, None] * m[:, None, :])

        # lengthscale gradients: dk/dl_d = phi(r) * Delta_d^2 / l_d^3
        d_ls = _lengthscale_grads(G * _dk_dl_factor(kernel, r, kernel_variance), X, lengthscales)
        # kernel variance: dK/dkv = k / kv; recompute the unit-variance gram
        k_unit, _ = _kernel_and_r(kernel, X, lengthscales, torch.ones_like(kernel_variance))
        d_kv = 0.5 * torch.sum(G * k_unit, dim=(1, 2))
        # likelihood variance: dK/dlv = I on valid rows
        d_lv = 0.5 * torch.sum(m * (alpha**2 - torch.diagonal(Kinv, dim1=1, dim2=2)), dim=-1)
        # d lml / dy = -K^-1 y = -alpha on valid rows
        dy = g[:, None] * (-alpha) * m
        return None, None, dy, None, g[:, None] * d_ls, g * d_kv, g * d_lv, None, None


def masked_gpr_lml_fused(
    kernel, X, y, mask, lengthscales, kernel_variance, likelihood_variance, jitter=0.0, factor: str = "block"
):
    """Masked GPR log marginal likelihood [B] with a hand-fused analytic VJP.

    X [B, N, D], y [B, N], mask [B, N], lengthscales [B, D],
    kernel_variance [B], likelihood_variance [B], jitter a float, factor one
    of ops/linalg.FACTOR_ROUTES.

    GRADIENT CONTRACT: differentiable w.r.t. lengthscales, kernel_variance,
    likelihood_variance and y (d lml / dy = -K^-1 y, for trainable mean
    functions). Coordinates are not: X must not require grad.
    """
    if X.requires_grad:
        raise ValueError("masked_gpr_lml_fused has no gradient for X; pass X without requires_grad")
    return _MaskedGPRLMLFused.apply(
        kernel, X, y, mask, lengthscales, kernel_variance, likelihood_variance, float(jitter), factor
    )


# --------------------------------------------------------------------------
# profiled (concentrated) LML: kernel variance solved in closed form
# --------------------------------------------------------------------------


def _profiled_gram(kernel, X, mask, lengthscales, tau, jitter):
    """Masked A = k_unit(ls) + (tau + jitter) I, with m, n and r."""
    m = mask.to(X.dtype)
    k, r = _kernel_and_r(kernel, X, lengthscales, torch.ones_like(tau))
    return LA.mask_gram(LA.add_diag(k, tau + jitter), m), m, m.sum(-1), r


def profiled_sigma2(kernel, X, y, mask, lengthscales, tau, jitter=0.0):
    """Closed-form sigma2_hat = y^T A^-1 y / n [B] at (lengthscales, tau),
    for every kernel name (A from ``linalg.profiled_gram``).

    All-masked (zero-observation) tiles, the engine's batch-padding lanes,
    return 1.0 instead of 0/0."""
    Am, m, n = LA.profiled_gram(X, mask, lengthscales, tau, kernel=kernel, jitter=float(jitter))
    v = LA.tri_solve(LA.cholesky(Am), (y * m)[:, :, None])
    return torch.where(n > 0, torch.sum(v * v, dim=(1, 2)) / torch.clamp_min(n, 1.0), torch.ones_like(n))


class _MaskedGPRLMLProfiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, X, y, mask, lengthscales, tau, jitter):
        # the factor is always ops/linalg.cholesky, as in the JAX package:
        # the other routes of masked_gpr_lml_fused are not wired here
        Am, m, n, r = _profiled_gram(kernel, X, mask, lengthscales, tau, jitter)
        ym = (y * m)[:, :, None]
        L = LA.cholesky(Am)
        del Am
        v = LA.tri_solve(L, ym)
        quad = torch.sum(v * v, dim=(1, 2))
        logdet = LA.logdet_from_chol(L)
        # all-masked lanes must give a finite value (0, like the joint path)
        # and zero gradients, not 0/0: sig2 is forced to 1 there (the
        # backward's alpha / sig2 terms are already zero through the mask)
        empty = n == 0
        sig2 = torch.where(empty, torch.ones_like(quad), quad / torch.clamp_min(n, 1.0))
        # joint lml at (ls, sig2, tau * sig2)
        lml = torch.where(
            empty,
            torch.zeros_like(quad),
            -0.5 * n * (1.0 + torch.log(sig2)) - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi),
        )
        W = LA.tri_inv_blocked(L)
        del L
        Ainv = torch.matmul(W.transpose(1, 2), W)
        alpha = torch.matmul(Ainv, ym)[:, :, 0]
        ctx.kernel = kernel
        ctx.save_for_backward(X, m, lengthscales, r, Ainv, alpha, sig2)
        return lml

    @staticmethod
    def backward(ctx, g):
        X, m, lengthscales, r, Ainv, alpha, sig2 = ctx.saved_tensors
        s = sig2[:, None]
        G = (alpha[:, :, None] * alpha[:, None, :] / s[:, :, None] - Ainv) * (m[:, :, None] * m[:, None, :])
        d_ls = _lengthscale_grads(G * _dk_dl_factor(ctx.kernel, r, torch.ones_like(sig2)), X, lengthscales)
        # dA/dtau = I on valid rows
        d_tau = 0.5 * torch.sum(m * (alpha**2 / s - torch.diagonal(Ainv, dim1=1, dim2=2)), dim=-1)
        # d lml / dy = -(A^-1 y) / sig2 on valid rows (envelope through sig2_hat)
        dy = g[:, None] * (-alpha / s) * m
        return None, None, dy, None, g[:, None] * d_ls, g * d_tau, None


def masked_gpr_lml_profiled(kernel, X, y, mask, lengthscales, tau, jitter=0.0):
    """Masked GPR LML [B] with the kernel variance profiled out.

    With K = sigma2 * A, A = k_unit(ls) + tau I (tau = noise/signal ratio),
    the LML's argmax over sigma2 is closed-form: sigma2_hat = y^T A^-1 y / n.
    This returns lml(ls, sigma2_hat, tau * sigma2_hat): the same optimum as
    the joint problem over one fewer search dimension, still one Cholesky
    per evaluation. Gradients (w.r.t. lengthscales, tau, y) follow the
    envelope theorem: G_p = alpha alpha^T / sigma2_hat - A^-1 replaces the
    joint form's G. Same gradient contract as ``masked_gpr_lml_fused``.
    """
    if X.requires_grad:
        raise ValueError("masked_gpr_lml_profiled has no gradient for X; pass X without requires_grad")
    return _MaskedGPRLMLProfiled.apply(kernel, X, y, mask, lengthscales, tau, float(jitter))
