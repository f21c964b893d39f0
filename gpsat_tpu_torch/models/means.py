"""Trainable prior mean functions — Constant and Linear.

Port of ``gpsat_tpu/models/means.py`` for batched tensors:

  Constant:  m(x) = c                      params: mean_c [B]
  Linear:    m(x) = A^T x + c              params: mean_A [B, D], mean_c [B]

``resolve_mean_kwargs`` reads a host model's ``mean_func_kwargs``.
A deterministic prior mean enters the objective through the centred
observations y - m(X), and predictions add m(Xnew) back. Mean params use
identity bijectors (they are unconstrained reals).
"""

from __future__ import annotations

import numpy as np

MEAN_FUNCTIONS = (None, "Constant", "Linear")


def validate(mean_function):
    if mean_function not in MEAN_FUNCTIONS:
        raise NotImplementedError(
            f"mean_function: {mean_function!r} not supported (use None, 'Constant' or 'Linear')"
        )
    return mean_function


def mean_param_names(mean_function) -> tuple:
    if mean_function == "Constant":
        return ("mean_c",)
    if mean_function == "Linear":
        return ("mean_c", "mean_A")
    return ()


def resolve_mean_kwargs(mean_func_kwargs: dict, mean_function) -> dict:
    """mean_func_kwargs -> {param name: value}, accepting both gpflow
    spellings of the intercept, Constant(c=...) and Linear(A, b) (ref: gpflow
    mean_functions.py). Unknown keys raise instead of being dropped."""
    kw = dict(mean_func_kwargs or {})
    out = {}
    for alias in ("c", "b"):
        if alias in kw:
            assert "mean_c" not in out, "pass only one of 'c'/'b' for the intercept"
            out["mean_c"] = kw.pop(alias)
    if "A" in kw:
        out["mean_A"] = kw.pop("A")
    assert not kw, (
        f"unknown mean_func_kwargs keys: {sorted(kw)} "
        "(accepted: 'c' or 'b' for the intercept, 'A' for the Linear slope)"
    )
    bad = [p for p in out if p not in mean_param_names(mean_function)]
    assert not bad, f"mean_func_kwargs {sorted(bad)} not applicable to mean_function={mean_function!r}"
    return out


def mean_param_defaults(mean_function, D: int, dtype=np.float64) -> dict:
    """Unbatched numpy defaults, as ``ModelCore.init_cparams`` returns them."""
    out = {}
    if mean_function in ("Constant", "Linear"):
        out["mean_c"] = np.asarray(0.0, dtype=dtype)
    if mean_function == "Linear":
        out["mean_A"] = np.zeros((D,), dtype=dtype)
    return out


def mean_value(cparams: dict, X):
    """m(X) -> [B, N] for X [B, N, D] (or 0.0 without mean params)."""
    out = 0.0
    if "mean_c" in cparams:
        out = out + cparams["mean_c"][:, None]
    if "mean_A" in cparams:
        out = out + (X * cparams["mean_A"][:, None, :]).sum(-1)
    return out


def has_mean(cparams: dict) -> bool:
    return "mean_c" in cparams or "mean_A" in cparams


def center_y(cparams: dict, data: dict) -> dict:
    """data with y replaced by y - m(X); no-op without mean params.
    Padded rows pick up arbitrary m values — harmless, they are masked."""
    if not has_mean(cparams):
        return data
    return {**data, "y": data["y"] - mean_value(cparams, data["X"])}


def add_mean(cparams: dict, Xnew, f_mean):
    """f_mean + m(Xnew); no-op without mean params."""
    if not has_mean(cparams):
        return f_mean
    return f_mean + mean_value(cparams, Xnew)
