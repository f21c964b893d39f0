"""Bijective parameter transforms (constrained <-> unconstrained).

Port of ``gpsat_tpu/ops/transforms.py``. Optimisation runs in unconstrained
space; ``forward`` maps to the constrained (physical) value. The positive
transform is softplus, as in GPflow, so unconstrained optima land in the
same place.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + exp(x)), overflow-safe for large |x|
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp_min(x, 0.0)


def inverse_softplus(y: torch.Tensor) -> torch.Tensor:
    # x = log(exp(y) - 1) = y + log(1 - exp(-y)), stable for large/small y
    y = torch.as_tensor(y)
    if not y.is_floating_point():
        y = y.to(torch.float64)
    eps_thresh = float(np.log(torch.finfo(y.dtype).eps)) + 2.0
    small = y < np.exp(eps_thresh)
    big = y > -eps_thresh
    # clip the argument of expm1 to keep the unused branch NaN-free under where()
    safe = torch.log(-torch.expm1(-torch.clamp_min(y, 1e-300))) + y
    out = torch.where(small, torch.log(torch.clamp_min(y, 1e-300)), torch.where(big, y, safe))
    return torch.where(y <= 0, torch.full_like(y, -float("inf")), out)


def sigmoid_lh(x: torch.Tensor, low, high) -> torch.Tensor:
    """Scaled sigmoid mapping R -> (low, high)."""
    low, high = _like(low, x), _like(high, x)
    return (high - low) * torch.reciprocal(1.0 + torch.exp(-x)) + low


def inverse_sigmoid_lh(y: torch.Tensor, low, high) -> torch.Tensor:
    y = torch.as_tensor(y)
    low, high = _like(low, y), _like(high, y)
    out = -torch.log((high - low) / (y - low) - 1.0)
    out = torch.where(y <= low, torch.full_like(out, -float("inf")), out)
    return torch.where(y >= high, torch.full_like(out, float("inf")), out)


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


@dataclasses.dataclass(frozen=True)
class Bijector:
    """A forward/inverse pair R^n -> constrained domain."""

    name: str = "softplus"
    # bounds used by the sigmoid bijector; arrays broadcast against the param
    low: Union[float, np.ndarray, None] = None
    high: Union[float, np.ndarray, None] = None
    # lower shift for the softplus bijector (gpflow positive_minimum analogue)
    shift: float = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "softplus":
            return softplus(x) + self.shift
        if self.name == "sigmoid":
            return sigmoid_lh(x, self.low, self.high)
        if self.name == "exp":
            return torch.exp(x)
        if self.name == "identity":
            return x
        raise ValueError(f"unknown bijector: {self.name}")

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        y = torch.as_tensor(y)
        if self.name == "softplus":
            return inverse_softplus(y - self.shift)
        if self.name == "sigmoid":
            # clamp the UNCONSTRAINED value to +-40, past which the sigmoid
            # saturates exactly to the bound in f32 and f64, so a param
            # stored at a saturated bound round-trips bitwise while
            # out-of-range inputs map to large-but-finite values
            return torch.clamp(inverse_sigmoid_lh(y, self.low, self.high), -40.0, 40.0)
        if self.name == "exp":
            return torch.log(y)
        if self.name == "identity":
            return y
        raise ValueError(f"unknown bijector: {self.name}")


POSITIVE = Bijector("softplus")
IDENTITY = Bijector("identity")


def interval(low, high) -> Bijector:
    """Sigmoid bijector onto (low, high)."""
    return Bijector("sigmoid", low=np.asarray(low, dtype=np.float64), high=np.asarray(high, dtype=np.float64))


def forward_params(unconstrained: dict, bijectors: dict) -> dict:
    """Map a dict of unconstrained params to constrained, using per-name
    bijectors (default: positive/softplus)."""
    return {k: bijectors.get(k, POSITIVE).forward(v) for k, v in unconstrained.items()}


def inverse_params(constrained: dict, bijectors: dict) -> dict:
    return {k: bijectors.get(k, POSITIVE).inverse(v) for k, v in constrained.items()}


def move_within_tol(vals, low, high, tol: float = 1e-8) -> np.ndarray:
    """Nudge values strictly inside [low+tol, high-tol] before applying a
    sigmoid constraint (ref: GPSat/models/gpflow_models.py:470-479)."""
    vals = np.atleast_1d(np.array(vals, dtype=float, copy=True))
    low = np.broadcast_to(np.asarray(low, dtype=float), vals.shape)
    high = np.broadcast_to(np.asarray(high, dtype=float), vals.shape)
    half_min_width = np.min(high - low) / 2.0
    tol = min(tol, half_min_width)
    vals = np.where(vals > high - tol, high - tol, vals)
    vals = np.where(vals < low + tol, low + tol, vals)
    return vals
