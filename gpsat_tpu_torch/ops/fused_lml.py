"""Masked GPR log marginal likelihood with analytic gradients, batched.

Port of ``gpsat_tpu/ops/fused_lml.py::masked_gpr_lml_fused`` (the
diagonal-block factor route). Autodiff through the factorisation would cost
another factorisation's worth of sequential work; the analytic form
(Rasmussen & Williams eq. 5.9) needs only

  forward:  K -> (L, W = L^-1) (ops/linalg.chol_winv_batched),
            v = W y, Kinv = W^T W, alpha = Kinv y, lml
  backward: dlml/dtheta = 0.5 sum(G * dK/dtheta),  G = alpha alpha^T - Kinv

with dK/dtheta in closed form per kernel: matmuls and elementwise work, no
triangular solves. The expert batch is the leading dimension B.
"""

from __future__ import annotations

import math

import torch

from gpsat_tpu_torch.ops import kernels as KK
from gpsat_tpu_torch.ops import linalg as LA

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979
_R_FLOOR = 1e-36  # same r^2 floor as ops.kernels so values agree exactly


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
        raise NotImplementedError(f"fused LML supports Matern12/32/52 + RBF, got {kernel}")
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
    raise NotImplementedError(kernel)


class _MaskedGPRLMLFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, X, y, mask, lengthscales, kernel_variance, likelihood_variance, jitter):
        m = mask.to(X.dtype)
        n = m.sum(-1)
        k, r = _kernel_and_r(kernel, X, lengthscales, kernel_variance)
        Km = LA.mask_gram(LA.add_diag(k, likelihood_variance + jitter), m)
        del k
        ym = (y * m)[:, :, None]
        L, W = LA.chol_winv_batched(Km)
        del Km
        v = torch.matmul(W, ym)
        quad = torch.sum(v * v, dim=(1, 2))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), dim=-1)
        del L
        lml = -0.5 * quad - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)
        Kinv = torch.matmul(W.transpose(1, 2), W)
        alpha = torch.matmul(Kinv, ym)[:, :, 0]
        ctx.kernel = kernel
        ctx.save_for_backward(X, m, lengthscales, kernel_variance, r, Kinv, alpha)
        return lml

    @staticmethod
    def backward(ctx, g):
        X, m, lengthscales, kernel_variance, r, Kinv, alpha = ctx.saved_tensors
        kernel = ctx.kernel
        G = (alpha[:, :, None] * alpha[:, None, :] - Kinv) * (m[:, :, None] * m[:, None, :])

        # lengthscale gradients: dk/dl_d = phi(r) * Delta_d^2 / l_d^3
        Gphi = G * _dk_dl_factor(kernel, r, kernel_variance)
        d_ls = torch.stack(
            [
                0.5 * torch.sum(Gphi * (X[:, :, d, None] - X[:, None, :, d]) ** 2, dim=(1, 2)) / lengthscales[:, d] ** 3
                for d in range(X.shape[-1])
            ],
            dim=-1,
        )
        del Gphi
        # kernel variance: dK/dkv = k / kv; recompute the unit-variance gram
        k_unit, _ = _kernel_and_r(kernel, X, lengthscales, torch.ones_like(kernel_variance))
        d_kv = 0.5 * torch.sum(G * k_unit, dim=(1, 2))
        # likelihood variance: dK/dlv = I on valid rows
        d_lv = 0.5 * torch.sum(m * (alpha**2 - torch.diagonal(Kinv, dim1=1, dim2=2)), dim=-1)
        # d lml / dy = -K^-1 y = -alpha on valid rows
        dy = g[:, None] * (-alpha) * m
        return None, None, dy, None, g[:, None] * d_ls, g * d_kv, g * d_lv, None


def masked_gpr_lml_fused(kernel, X, y, mask, lengthscales, kernel_variance, likelihood_variance, jitter=0.0):
    """Masked GPR log marginal likelihood [B] with a hand-fused analytic VJP.

    X [B, N, D], y [B, N], mask [B, N], lengthscales [B, D],
    kernel_variance [B], likelihood_variance [B], jitter a float.

    GRADIENT CONTRACT: differentiable w.r.t. lengthscales, kernel_variance,
    likelihood_variance and y (d lml / dy = -K^-1 y, for trainable mean
    functions). Coordinates are not: X must not require grad.
    """
    if X.requires_grad:
        raise ValueError("masked_gpr_lml_fused has no gradient for X; pass X without requires_grad")
    return _MaskedGPRLMLFused.apply(kernel, X, y, mask, lengthscales, kernel_variance, likelihood_variance, float(jitter))
