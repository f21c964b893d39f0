"""Functional model cores — what the batched engine runs.

Port of ``gpsat_tpu/models/functional.py`` for the exact-GPR family (joint
and profiled-variance); the sparse cores live in ``sgpr.py`` and
``svgp.py``, the inter-domain ones in ``vff.py`` and ``asvgp.py``. A
ModelCore bundles the functions the engine needs; every one acts on a
whole expert batch (leading dimension B) instead of one tile under vmap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gpsat_tpu_torch.models import gpr as gpr_core
from gpsat_tpu_torch.models import means as MF
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import transforms as T


@dataclasses.dataclass(frozen=True)
class ModelCore:
    name: str
    objective: Callable  # (uparams, data) -> [B] loss (minimized)
    predict: Callable  # (cparams, data, Xnew) -> {"f_mean", "f_var", "y_var"}
    forward: Callable  # uparams -> cparams
    inverse: Callable  # cparams -> uparams
    init_cparams: Callable  # (D, dtype, overrides) -> cparams (unbatched numpy)
    param_names: tuple
    # params held fixed during optimisation unless explicitly trained
    default_fixed_params: tuple = ()
    # optional host-side hook before padding: (TileBatch, init_cparams) ->
    # init_cparams, for starts computed from the bucket's tiles. Applied by
    # run_tile_batch_async after smart_init fills its params.
    prepare_batch_init: Optional[Callable] = None
    # optional hook before optimisation: (uparams0, data) -> uparams0, for
    # data-dependent or reparameterised starts. Applied only when
    # optimise=True: predict-only runs honour loaded params verbatim.
    device_init: Optional[Callable] = None
    # optional hook after optimisation, before predict: (cparams, data) ->
    # cparams, for params that are a closed-form function of the optimised
    # ones. Applied only when optimise=True.
    finalize_params: Optional[Callable] = None
    # optional objective for the 'objective' column of predict-only runs,
    # whose uparams are in the STANDARD parameterisation. A core whose
    # training objective reinterprets a param slot (the profiled GPR carries
    # tau in the likelihood_variance slot) sets this to the standard
    # objective. Defaults to ``objective``.
    report_objective: Optional[Callable] = None
    # which batched runner fits this core: "lbfgs" (make_batched_runner) or
    # "adam" (make_batched_adam_runner, the SVGP core's reference optimiser)
    optimizer: str = "lbfgs"
    # optional natural-gradient hook of the Adam runner: (uparams, data) ->
    # new values of natgrad_params, called before every Adam step; those
    # params are kept out of Adam (the reference's hybrid optimiser)
    natgrad_update: Optional[Callable] = None
    natgrad_params: tuple = ()
    # inter-domain cores (VFF, ASVGP): D -> the feature count Mtot of their
    # factor pairs, whose [B, Mtot, Mtot] buffers the sweep's memory cap sizes
    num_features: Optional[Callable] = None


def make_gpr_core(
    kernel: str = "Matern32",
    bijectors: Optional[dict] = None,
    jitter: float = 0.0,
    mean_function: Optional[str] = None,
    factor: str = "block",
    profile_variance: bool = False,
) -> ModelCore:
    """Exact GPR core (objective = negative log marginal likelihood).

    mean_function "Constant"/"Linear" adds trainable per-expert prior-mean
    params mean_c (+ mean_A [D] for Linear) with identity bijectors.

    factor names the factor route of the objective and the predict
    (ops/linalg.FACTOR_ROUTES; the JAX package reads environment variables
    for it).

    profile_variance=True (experimental, opt-in) optimises the concentrated
    LML: the kernel variance is closed-form per evaluation and the search
    runs over (lengthscales, tau = lv / kv) only: the same optimum on
    well-behaved tiles, one fewer dimension, one Cholesky per iteration (+1
    in finalize_params). Its objective always factors with
    ops/linalg.cholesky; ``factor`` still names the predict's route. It
    requires plain POSITIVE bijectors on kernel_variance and
    likelihood_variance. The concentrated surface makes the degenerate
    pure-noise stationary point (lengthscales -> 0) reachable in the first
    optimiser steps on some tiles (about one lane in eight), which then
    converge there with a worse objective: keep it off unless the workload is
    known not to degenerate.
    """
    if factor not in LA.FACTOR_ROUTES:
        raise ValueError(f"factor must be one of {LA.FACTOR_ROUTES}, got {factor!r}")
    MF.validate(mean_function)
    if bijectors is None:
        bijectors = {name: T.POSITIVE for name in gpr_core.PARAM_NAMES}
    bijectors = dict(bijectors)
    for p in MF.mean_param_names(mean_function):
        bijectors.setdefault(p, T.IDENTITY)

    if profile_variance:
        assert bijectors.get("kernel_variance") is T.POSITIVE and bijectors.get("likelihood_variance") is T.POSITIVE, (
            "profile_variance requires unconstrained-positive kernel/likelihood "
            "variances (interval constraints change the feasible set of the "
            "profiled parameterization): drop the constraints or use the joint path"
        )
        return _make_profiled_gpr_core(kernel, bijectors, jitter, mean_function, factor)

    def objective(uparams, data):
        return gpr_core.neg_lml(uparams, data, kernel=kernel, bijectors=bijectors, jitter=jitter, factor=factor)

    def predict(cparams, data, Xnew):
        return gpr_core.predict(cparams, data, Xnew, kernel=kernel, jitter=jitter, factor=factor)

    def forward(uparams):
        return {k: bijectors[k].forward(v) for k, v in uparams.items()}

    def inverse(cparams):
        return {k: bijectors[k].inverse(torch.as_tensor(v)) for k, v in cparams.items()}

    def init_cparams(D: int, dtype=np.float64, overrides: Optional[dict] = None) -> Dict[str, np.ndarray]:
        out = {
            "lengthscales": np.ones((D,), dtype=dtype),
            "kernel_variance": np.asarray(1.0, dtype=dtype),
            "likelihood_variance": np.asarray(1.0, dtype=dtype),
        }
        out.update(MF.mean_param_defaults(mean_function, D, dtype=dtype))
        for k, v in (overrides or {}).items():
            if k not in out:
                continue
            v = np.asarray(v, dtype=dtype)
            out[k] = np.broadcast_to(v, out[k].shape).copy() if v.ndim < np.ndim(out[k]) else v
        return out

    return ModelCore(
        name=f"GPR[{kernel}]",
        objective=objective,
        predict=predict,
        forward=forward,
        inverse=inverse,
        init_cparams=init_cparams,
        param_names=tuple(gpr_core.PARAM_NAMES) + MF.mean_param_names(mean_function),
    )


def _make_profiled_gpr_core(kernel, bijectors, jitter, mean_function, factor) -> ModelCore:
    """Concentrated-LML GPR core (see make_gpr_core(profile_variance=True)).

    During optimisation the 'likelihood_variance' slot carries tau = lv / kv
    and kernel_variance is held fixed (the objective ignores it).
    device_init maps the caller's (kv0, lv0) to tau0; finalize_params
    computes sigma2_hat once at the optimum and restores the true
    (kernel_variance, likelihood_variance), so results and predictions are
    in the standard parameterisation.
    """
    base = make_gpr_core(kernel=kernel, bijectors=bijectors, jitter=jitter, mean_function=mean_function, factor=factor)

    def objective(uparams, data):
        return gpr_core.neg_lml_profiled(uparams, data, kernel=kernel, bijectors=bijectors, jitter=jitter)

    def device_init(uparams0, data):
        kv = bijectors["kernel_variance"].forward(uparams0["kernel_variance"])
        lv = bijectors["likelihood_variance"].forward(uparams0["likelihood_variance"])
        return {**uparams0, "likelihood_variance": bijectors["likelihood_variance"].inverse(lv / kv)}

    def finalize_params(cparams, data):
        tau = cparams["likelihood_variance"]
        sig2 = gpr_core.profiled_sigma2_hat(cparams, data, kernel=kernel, jitter=jitter)
        return {**cparams, "kernel_variance": sig2, "likelihood_variance": tau * sig2}

    return dataclasses.replace(
        base,
        name=f"GPR[{kernel},profiled]",
        objective=objective,
        default_fixed_params=("kernel_variance",),
        device_init=device_init,
        finalize_params=finalize_params,
        # predict-only runs load standard (kv, lv) params: report the joint
        # neg-LML there, not the profiled objective, which would read the lv
        # slot as tau and ignore kv
        report_objective=base.objective,
    )
