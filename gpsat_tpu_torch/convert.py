"""Carry the JAX package's state across to the port, through numpy only.

``params_from_numpy`` turns constrained hyperparameters as the JAX engine
returns them (``run_tile_batch`` result columns, or a stored params table)
into the port's tensors. ``batch_from_numpy`` copies any object with the
``TileBatch`` attributes into the port's ``TileBatch``. Neither imports
the JAX package.

The profiled-variance GPR core (``make_gpr_core(profile_variance=True)``)
keeps the standard parameter names and returns standard
``(kernel_variance, likelihood_variance)`` from both packages, so its results
are carried by ``params_from_numpy`` as they are: there is no extra state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from gpsat_tpu_torch.parallel.batching import TileBatch


def params_from_numpy(cparams: Dict[str, np.ndarray], device, dtype) -> Dict[str, torch.Tensor]:
    """{name: [B, ...] numpy} -> {name: [B, ...] tensor on device, dtype}.

    Every parameter carries across as it is, the SVGP core's inducing_mean
    [B, M] and inducing_chol [B, M, M] included: the factor's upper
    triangle is kept as the JAX package stores it (a free L-BFGS or Adam
    factor may hold values there), and each consumer applies ``tril`` where
    it uses the factor, as the JAX package does. VFF's per-tile domain
    [B, D, 2] and ASVGP's knot grids [B, D, M] carry across as they are:
    fixed parameters with the identity bijector in both packages, so the
    JAX package's values give the port the same features."""
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device) for k, v in cparams.items()}


def batch_from_numpy(obj) -> TileBatch:
    """The port's TileBatch from any object carrying TileBatch's fields."""
    rep = {}
    for f in dataclasses.fields(TileBatch):
        v = getattr(obj, f.name, None)
        if v is None and f.default is dataclasses.MISSING:
            raise AttributeError(f"{type(obj).__name__} has no TileBatch field {f.name!r}")
        rep[f.name] = None if v is None else np.array(v)
    return TileBatch(**rep)
