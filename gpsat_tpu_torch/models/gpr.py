"""Exact Gaussian-process regression — functional core batched over B, and
the host-facing single-expert model.

Port of ``gpsat_tpu/models/gpr.py``: ``neg_lml`` (the fused
analytic-gradient LML), ``neg_lml_profiled`` and ``profiled_sigma2_hat``
(the kernel variance solved in closed form), ``posterior_factors``,
``predict`` and ``GPRModel``, which evaluates them at B = 1. Data is
``{"X": [B, N, D], "y": [B, N], "mask": [B, N]}``; params are dicts of
[B, ...] tensors.
``factor`` names the factor route (ops/linalg.FACTOR_ROUTES).

Both objectives use the fused analytic-gradient form in every dtype for the
kernels that have it (``fused_lml.FUSED_KERNELS``; the JAX package keeps an
autodiff form for f64, which gives the same value and gradients).
RationalQuadratic, Cosine and White take the autodiff forms, as in the JAX
package: ``ops/linalg.masked_gpr_lml`` for ``neg_lml`` and
``ops/linalg.masked_gpr_lml_profiled`` for ``neg_lml_profiled``, both with
gradients through ``ops/cholesky``'s backward.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gpsat_tpu_torch.models import means as MF
from gpsat_tpu_torch.models.base import BaseGPRModel, TorchCoreModel, lane_param_names
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
    A kernel outside ``FUSED_KERNELS`` takes the autodiff form, whose factor
    is ``linalg.cholesky`` (kernel 3 in its domain on the card).
    """
    p = T.forward_params(uparams, bijectors)
    data = MF.center_y(p, data)
    args = (data["X"], data["y"], data["mask"], p["lengthscales"], p["likelihood_variance"])
    if kernel not in FUSED_KERNELS:
        return -LA.masked_gpr_lml_profiled(*args, kernel=kernel, jitter=jitter)
    return -masked_gpr_lml_profiled(kernel, *args, jitter)


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


# --------------------------------------------------------------------------
# host-facing single-expert model
# --------------------------------------------------------------------------


def default_init_params(D: int, dtype=torch.float64, device=None) -> dict:
    """gpflow defaults: unit lengthscales [D] and variances (gpflow_models.py:129-135)."""
    return {
        "lengthscales": torch.ones((D,), dtype=dtype, device=device),
        "kernel_variance": torch.tensor(1.0, dtype=dtype, device=device),
        "likelihood_variance": torch.tensor(1.0, dtype=dtype, device=device),
    }


class GPRModel(TorchCoreModel):
    """Exact GPR on one expert (the reference's GPflowGPRModel contract;
    gpsat_tpu/models/gpr.py::GPRModel): param names ``lengthscales,
    kernel_variance, likelihood_variance`` (+ mean_c, mean_A with a mean
    function); predict returns ``{"f*", "f*_var", "y_var", "f_bar"}`` (+
    ``f*_cov``, ``y_cov`` with ``full_cov``); constraints are sigmoid
    reparameterisations; the fit is L-BFGS (zoom by default).

    It evaluates the batched functions ``neg_lml`` and ``predict`` at B = 1
    on ``device`` (default: the card) in ``dtype`` (default f64; f32 also
    takes the f32 tolerances and the single-eval search). In f32 on the
    card every factor pair runs through kernel 1 on the "block" route.
    Read on the class, ``param_names`` is the batched lane's."""

    PARAM_NAMES = tuple(PARAM_NAMES)
    param_names = lane_param_names(PARAM_NAMES)

    def __init__(
        self,
        data=None,
        coords_col=None,
        obs_col=None,
        coords=None,
        obs=None,
        coords_scale=None,
        obs_scale=None,
        obs_mean=None,
        verbose: bool = False,
        *,
        kernel: str = "Matern32",
        kernel_kwargs: Optional[dict] = None,
        noise_variance: Optional[float] = None,
        jitter: float = 0.0,
        device=None,
        dtype=torch.float64,
        **kwargs,
    ):
        self._init_device(device, dtype)
        super().__init__(
            data=data,
            coords_col=coords_col,
            obs_col=obs_col,
            coords=coords,
            obs=obs,
            coords_scale=coords_scale,
            obs_scale=obs_scale,
            obs_mean=obs_mean,
            verbose=verbose,
        )
        # trainable Constant / Linear prior means (ref: gpflow_models.py:143-157)
        self.mean_function = MF.validate(kwargs.pop("mean_function", None))
        mean_func_kwargs = dict(kwargs.pop("mean_func_kwargs", None) or {})
        assert kernel in K.KERNEL_NAMES, f"kernel: {kernel} not in {K.KERNEL_NAMES}"
        self.kernel = kernel
        self.kernel_kwargs = dict(kernel_kwargs or {})
        self.jitter = jitter
        D = self.coords.shape[1]
        self._init_gpr_params(
            self.kernel_kwargs.pop("lengthscales", np.ones(D)),
            self.kernel_kwargs.pop("variance", 1.0),
            noise_variance,
            self.mean_function,
            MF.resolve_mean_kwargs(mean_func_kwargs, self.mean_function),
        )

    def update_obs_data(self, data=None, coords_col=None, obs_col=None, coords=None, obs=None, coords_scale=None,
                        obs_scale=None, obs_mean=None):
        """Swap the observation data in place, keeping the hyperparameters
        (ref: gpflow_models.py:331-349: the base data ingestion again, its
        arguments passed through, so omitted scales reset to their
        defaults as in the reference)."""
        BaseGPRModel.__init__(
            self,
            data=data,
            coords_col=coords_col,
            obs_col=obs_col,
            coords=coords,
            obs=obs,
            coords_scale=coords_scale,
            obs_scale=obs_scale,
            obs_mean=obs_mean,
        )
        assert self.coords.shape[1] == len(self._params["lengthscales"]), (
            "update_obs_data changed the coordinate dimension; rebuild the model instead"
        )

    def _neg_lml(self, cparams: dict, data: dict) -> torch.Tensor:
        identity = {k: T.IDENTITY for k in cparams}
        return neg_lml(cparams, data, kernel=self.kernel, bijectors=identity, jitter=self.jitter)

    def optimise_parameters(self, max_iter: int = 10_000, fixed_params=None, **opt_kwargs) -> bool:
        data = self._data_dict()
        return self._minimize(lambda c: self._neg_lml(c, data), list(fixed_params or []), max_iter, **opt_kwargs)

    def get_objective_function_value(self) -> float:
        """The negative log marginal likelihood (the reference reports the
        negative LML for GPR, gpflow_models.py:334-337)."""
        with torch.no_grad():
            return float(self._neg_lml(self._cparams(), self._data_dict())[0])

    def predict(self, coords, full_cov: bool = False, apply_scale: bool = True) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            pred = predict(self._cparams(), self._data_dict(), self._prediction_tensor(coords, apply_scale),
                           kernel=self.kernel, jitter=self.jitter, full_cov=full_cov)
        return self._prediction_out(pred, full_cov)
