"""Stationary covariance (Gram) construction, batched over experts.

Port of ``gpsat_tpu/ops/kernels.py``: all nine kernel names. Every
function takes a leading expert dimension B: coordinates [B, N, D],
lengthscales [B, D], variances [B].

  r^2 = sum_d ((x1_d - x2_d) / lengthscale_d)^2     (ARD)
  Matern12: s2 * exp(-r)
  Matern32: s2 * (1 + sqrt(3) r) exp(-sqrt(3) r)
  Matern52: s2 * (1 + sqrt(5) r + 5 r^2/3) exp(-sqrt(5) r)
  RBF:      s2 * exp(-r^2 / 2)
  RationalQuadratic: s2 * (1 + r^2 / (2 alpha))^(-alpha), alpha = 1
  Cosine:   s2 * cos(2 pi sum_d (x1_d - x2_d) / l_d)   (a signed sum)
  White:    zeros (the model's noise on the diagonal is the whole covariance)

Only the first six have the fused analytic-gradient LML (``ops/fused_lml``);
``models/gpr.neg_lml`` fits the other three through the autodiff LML.
"""

from __future__ import annotations

import math

import torch

# smallest r^2 fed to sqrt: keeps d(sqrt)/dr2 finite at coincident points
_R2_FLOOR = 1e-36
# RationalQuadratic's shape: the reference's default, which its objective
# and predict always use
_RQ_ALPHA = 1.0

KERNEL_NAMES = (
    "Matern12",
    "Exponential",
    "Matern32",
    "Matern52",
    "RBF",
    "SquaredExponential",
    "RationalQuadratic",
    "Cosine",
    "White",
)


def scaled_squared_dist(X1: torch.Tensor, X2: torch.Tensor, lengthscales: torch.Tensor) -> torch.Tensor:
    """[B,N,D],[B,M,D],[B,D] -> [B,N,M] squared euclidean distance of X/l.

    Uses |a-b|^2 = |a|^2 + |b|^2 - 2 a.b so the N*M*D work is one matmul
    (full f32: the package turns TF32 off), clamped at 0.
    """
    ls = lengthscales[:, None, :]
    Xs1 = X1 / ls
    Xs2 = X2 / ls
    sq1 = torch.sum(Xs1 * Xs1, dim=-1)[:, :, None]
    sq2 = torch.sum(Xs2 * Xs2, dim=-1)[:, None, :]
    r2 = sq1 + sq2 - 2.0 * torch.matmul(Xs1, Xs2.transpose(1, 2))
    return torch.clamp_min(r2, 0.0)


def _r_from_r2(r2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(r2, _R2_FLOOR))


def gram(kernel: str, X1: torch.Tensor, X2: torch.Tensor, lengthscales: torch.Tensor, variance: torch.Tensor) -> torch.Tensor:
    """Cross-covariance k(X1, X2) -> [B, N, M]."""
    if kernel not in KERNEL_NAMES:
        raise ValueError(f"unknown kernel: {kernel}; valid: {KERNEL_NAMES}")
    s2 = variance[:, None, None]
    if kernel == "White":
        return X1.new_zeros(X1.shape[0], X1.shape[1], X2.shape[1])
    if kernel == "Cosine":
        d = torch.sum((X1[:, :, None, :] - X2[:, None, :, :]) / lengthscales[:, None, None, :], dim=-1)
        return s2 * torch.cos(2.0 * math.pi * d)
    r2 = scaled_squared_dist(X1, X2, lengthscales)
    if kernel == "RationalQuadratic":
        return s2 * torch.pow(1.0 + r2 / (2.0 * _RQ_ALPHA), -_RQ_ALPHA)
    if kernel in ("RBF", "SquaredExponential"):
        return s2 * torch.exp(-0.5 * r2)
    r = _r_from_r2(r2)
    if kernel in ("Matern12", "Exponential"):
        return s2 * torch.exp(-r)
    if kernel == "Matern32":
        sqrt3_r = math.sqrt(3.0) * r
        return s2 * (1.0 + sqrt3_r) * torch.exp(-sqrt3_r)
    sqrt5_r = math.sqrt(5.0) * r
    return s2 * (1.0 + sqrt5_r + 5.0 / 3.0 * r2) * torch.exp(-sqrt5_r)


def gram_diag(kernel: str, X: torch.Tensor, variance: torch.Tensor) -> torch.Tensor:
    """Diagonal of k(X, X) -> [B, N] (stationary => variance everywhere)."""
    return torch.ones(X.shape[:2], dtype=X.dtype, device=X.device) * variance[:, None]
