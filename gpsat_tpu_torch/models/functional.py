"""Functional model cores — what the batched engine runs.

Port of ``gpsat_tpu/models/functional.py`` for the exact-GPR joint path. A
ModelCore bundles the functions the engine needs; every one acts on a whole
expert batch (leading dimension B) instead of one tile under vmap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gpsat_tpu_torch.models import gpr as gpr_core
from gpsat_tpu_torch.models import means as MF
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


def make_gpr_core(
    kernel: str = "Matern32",
    bijectors: Optional[dict] = None,
    jitter: float = 0.0,
    mean_function: Optional[str] = None,
    profile_variance: bool = False,
) -> ModelCore:
    """Exact GPR core (objective = negative log marginal likelihood).

    mean_function "Constant"/"Linear" adds trainable per-expert prior-mean
    params mean_c (+ mean_A [D] for Linear) with identity bijectors.
    """
    if profile_variance:
        raise NotImplementedError(
            "profile_variance=True (the profiled LML) is not ported yet; see ROADMAP.md"
        )
    MF.validate(mean_function)
    if bijectors is None:
        bijectors = {name: T.POSITIVE for name in gpr_core.PARAM_NAMES}
    bijectors = dict(bijectors)
    for p in MF.mean_param_names(mean_function):
        bijectors.setdefault(p, T.IDENTITY)

    def objective(uparams, data):
        return gpr_core.neg_lml(uparams, data, kernel=kernel, bijectors=bijectors, jitter=jitter)

    def predict(cparams, data, Xnew):
        return gpr_core.predict(cparams, data, Xnew, kernel=kernel, jitter=jitter)

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
