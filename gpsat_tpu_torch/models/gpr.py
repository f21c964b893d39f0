"""Exact Gaussian-process regression — functional core, batched over B.

Port of the functional part of ``gpsat_tpu/models/gpr.py``: ``neg_lml``
(the fused analytic-gradient LML), ``neg_lml_profiled`` and
``profiled_sigma2_hat`` (the kernel variance solved in closed form),
``posterior_factors`` and ``predict``. Data is ``{"X": [B, N, D],
"y": [B, N], "mask": [B, N]}``; params are dicts of [B, ...] tensors.
``factor`` names the factor route (ops/linalg.FACTOR_ROUTES).

Both objectives use the fused analytic-gradient form in every dtype for the
kernels that have it (``fused_lml.FUSED_KERNELS``; the JAX package keeps an
autodiff form for f64, which gives the same value and gradients).
``neg_lml`` fits RationalQuadratic, Cosine and White through the autodiff
LML, ``ops/linalg.masked_gpr_lml``, as the reference does; the profiled
objective takes the fused kernels only.
"""

from __future__ import annotations

import torch

from gpsat_tpu_torch.models import means as MF
from gpsat_tpu_torch.ops import kernels as K
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import transforms as T
from gpsat_tpu_torch.ops.fused_lml import FUSED_KERNELS, masked_gpr_lml_fused, masked_gpr_lml_profiled, profiled_sigma2

PARAM_NAMES = ["lengthscales", "kernel_variance", "likelihood_variance"]


def neg_lml(uparams: dict, data: dict, *, kernel: str, bijectors: dict, jitter: float = 0.0, factor: str = "block"):
    """Negative log marginal likelihood [B] of padded tiles.

    uparams: unconstrained {"lengthscales": [B, D], "kernel_variance": [B],
    "likelihood_variance": [B]}. Gradients reach uparams (through the
    bijectors) and y. A kernel outside ``FUSED_KERNELS`` takes the autodiff
    LML, whose factor is ``linalg.cholesky`` whatever ``factor`` says.
    """
    p = T.forward_params(uparams, bijectors)
    data = MF.center_y(p, data)
    if kernel not in FUSED_KERNELS:
        return -LA.masked_gpr_lml(
            data["X"],
            data["y"],
            data["mask"],
            p["lengthscales"],
            p["kernel_variance"],
            p["likelihood_variance"],
            kernel=kernel,
            jitter=jitter,
        )
    return -masked_gpr_lml_fused(
        kernel,
        data["X"],
        data["y"],
        data["mask"],
        p["lengthscales"],
        p["kernel_variance"],
        p["likelihood_variance"],
        jitter,
        factor,
    )


def neg_lml_profiled(uparams: dict, data: dict, *, kernel: str, bijectors: dict, jitter: float = 0.0):
    """Profiled (concentrated) negative LML [B]: the kernel variance is solved
    in closed form each evaluation (sigma2_hat = y^T A^-1 y / n with
    A = k_unit + tau I), so the optimiser searches one fewer dimension.

    The 'likelihood_variance' slot of uparams holds tau = lv / kv; the
    'kernel_variance' slot is ignored (held fixed by the core). Same optimum
    as ``neg_lml`` over (ls, kv, lv); ``profiled_sigma2_hat`` maps back.
    """
    p = T.forward_params(uparams, bijectors)
    data = MF.center_y(p, data)
    return -masked_gpr_lml_profiled(
        kernel, data["X"], data["y"], data["mask"], p["lengthscales"], p["likelihood_variance"], jitter
    )


def profiled_sigma2_hat(cparams: dict, data: dict, *, kernel: str, jitter: float = 0.0):
    """sigma2_hat [B] at cparams whose 'likelihood_variance' slot holds tau."""
    data = MF.center_y(cparams, data)
    return profiled_sigma2(
        kernel, data["X"], data["y"], data["mask"], cparams["lengthscales"], cparams["likelihood_variance"], jitter
    )


def posterior_factors(cparams: dict, data: dict, *, kernel: str, jitter: float = 0.0, factor: str = "block"):
    """Factor pair for fitted tiles: (L, alpha, W) with alpha = K^-1 y [B, N, 1]
    and W = L^-1. "block" and "recursive" take the pair from their route;
    "panel" and "cholesky" take ``cholesky`` + ``tri_inv_blocked``."""
    m = data["mask"].to(data["X"].dtype)
    Kf = K.gram(kernel, data["X"], data["X"], cparams["lengthscales"], cparams["kernel_variance"])
    Km = LA.mask_gram(LA.add_diag(Kf, cparams["likelihood_variance"] + jitter), m)
    ym = (data["y"] * m)[:, :, None]
    L, W = LA.chol_winv_pair(Km, factor if factor in ("block", "recursive") else "cholesky")
    alpha = torch.matmul(W.transpose(1, 2), torch.matmul(W, ym))
    return L, alpha, W


def predict(
    cparams: dict,
    data: dict,
    Xnew: torch.Tensor,
    *,
    kernel: str,
    jitter: float = 0.0,
    full_cov: bool = False,
    factor: str = "block",
):
    """Posterior mean/variance at Xnew [B, P, D] (already coords_scale'd).

    Returns f_mean, f_var, y_var [B, P] (and f_cov [B, P, P] when full_cov).
    Padded training rows contribute nothing (zeroed cross-gram).
    """
    m = data["mask"].to(Xnew.dtype)
    data = MF.center_y(cparams, data)
    _, alpha, W = posterior_factors(cparams, data, kernel=kernel, jitter=jitter, factor=factor)
    Ks = K.gram(kernel, data["X"], Xnew, cparams["lengthscales"], cparams["kernel_variance"])
    Ks = Ks * m[:, :, None]
    f_mean = MF.add_mean(cparams, Xnew, torch.matmul(Ks.transpose(1, 2), alpha)[:, :, 0])
    v = torch.matmul(W, Ks)
    f_var = K.gram_diag(kernel, Xnew, cparams["kernel_variance"]) - torch.sum(v * v, dim=1)
    out = {
        "f_mean": f_mean,
        "f_var": f_var,
        "y_var": f_var + cparams["likelihood_variance"][:, None],
    }
    if full_cov:
        Kss = K.gram(kernel, Xnew, Xnew, cparams["lengthscales"], cparams["kernel_variance"])
        out["f_cov"] = Kss - torch.matmul(v.transpose(1, 2), v)
    return out
