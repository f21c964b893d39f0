"""Torch exact GPR (the reference's GPyTorchGPRModel slot) and KISS-GP.

The port's own copy of ``gpsat_tpu/models/torch_gpr.py``. The reference
wraps GPyTorch (ref: GPSat/models/gpytorch_models.py:17-512: float32,
Adam(lr=0.1) or LBFGS for a FIXED 30 iterations with no convergence check,
an extra 'smoothness' (Matern nu) parameter). This is the same exact-GPR
math in plain torch with the reference's training semantics, the
fixed-iteration optimiser included, and the BaseGPRModel contract.
TorchKISSGPModel mirrors the reference's GPyTorchKISSGPModel (ref:
gpytorch_models.py:321-382, ScaleKernel(GridInterpolationKernel)):
structured kernel interpolation K ~= W Kuu W^T on a per-dimension uniform
grid with multilinear interpolation weights.

The reference pins these models to the CPU (and the JAX package's copy
does too); here they run on ``device`` (default: the card, which must
exist) in ``dtype`` (default float32, the reference's precision).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from gpsat_tpu_torch.models.base import BaseGPRModel


def _matern(dist, nu: float):
    if nu == 0.5:
        return torch.exp(-dist)
    if nu == 1.5:
        a = math.sqrt(3.0) * dist
        return (1 + a) * torch.exp(-a)
    if nu == 2.5:
        a = math.sqrt(5.0) * dist
        return (1 + a + a**2 / 3.0) * torch.exp(-a)
    raise ValueError(f"smoothness (nu) must be one of 0.5/1.5/2.5, got {nu}")


class TorchGPRModel(BaseGPRModel):
    """Exact GPR in plain torch on ``device`` in ``dtype``."""

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
        kernel: str = "Matern",
        smoothness: float = 1.5,
        noise_variance: Optional[float] = None,
        device=None,
        dtype=torch.float32,
        **kwargs,
    ):
        from gpsat_tpu_torch.parallel.engine import resolve_device

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
        self.device = resolve_device(device)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        D = self.coords.shape[1]
        self.X = self._t(self.coords)
        self.Y = self._t(self.obs[:, 0])
        self.raw_ls = torch.zeros(D, dtype=self.dtype, device=self.device, requires_grad=True)
        self.raw_kv = torch.zeros((), dtype=self.dtype, device=self.device, requires_grad=True)
        init_nv = 1.0 if noise_variance is None else float(noise_variance)
        self.raw_nv = self._t(float(np.log(np.expm1(init_nv))) if init_nv > 1e-6 else -13.0).requires_grad_(True)
        self.smoothness = float(smoothness)
        # per-raw-param interval constraints; softplus when unconstrained
        # (gpytorch's default), sigmoid-interval once set_*_constraints is
        # called (gpytorch's Interval; ref: gpytorch_models.py:238-320)
        self._intervals = {}

    def _t(self, a) -> torch.Tensor:
        return torch.tensor(a, dtype=self.dtype, device=self.device)

    def _eye(self, n: int) -> torch.Tensor:
        return torch.eye(n, dtype=self.dtype, device=self.device)

    @staticmethod
    def _numpy(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().astype(float)

    def _val(self, attr):
        raw = getattr(self, attr)
        iv = self._intervals.get(attr)
        if iv is None:
            return torch.nn.functional.softplus(raw)
        low, high = iv
        return low + (high - low) * torch.sigmoid(raw)

    def _gram(self, X1, X2):
        ls = self._val("raw_ls")
        d = torch.cdist(X1 / ls, X2 / ls)
        return self._val("raw_kv") * _matern(d, self.smoothness)

    def _prior_var(self, Xs):
        """Prior variance diag k(x*, x*); the approximations override it."""
        return self._val("raw_kv")

    def _neg_lml(self):
        n = self.X.shape[0]
        K = self._gram(self.X, self.X) + self._val("raw_nv") * self._eye(n)
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(self.Y[:, None], L)
        return 0.5 * (self.Y[:, None] * alpha).sum() + torch.log(torch.diagonal(L)).sum() + 0.5 * n * math.log(
            2 * math.pi)

    @property
    def param_names(self) -> List[str]:
        return ["lengthscales", "kernel_variance", "likelihood_variance", "smoothness"]

    def optimise_parameters(self, optimiser: str = "adam", n_iter: int = 30, lr: float = 0.1, **kwargs) -> bool:
        """Fixed-iteration Adam or LBFGS with no convergence check (the
        reference's semantics, gpytorch_models.py:182-215)."""
        params = [self.raw_ls, self.raw_kv, self.raw_nv]
        if optimiser.lower() == "adam":
            opt = torch.optim.Adam(params, lr=lr)
            for _ in range(n_iter):
                opt.zero_grad()
                loss = self._neg_lml()
                loss.backward()
                opt.step()
        else:
            opt = torch.optim.LBFGS(params, lr=lr, max_iter=20)

            def closure():
                opt.zero_grad()
                loss = self._neg_lml()
                loss.backward()
                return loss

            for _ in range(n_iter):
                opt.step(closure)
        # a fixed-iteration loop: the count is n_iter
        self._last_num_iter = int(n_iter)
        return bool(torch.isfinite(self._neg_lml()))

    def get_objective_function_value(self) -> float:
        return float(self._neg_lml().detach())

    def predict(self, coords, full_cov: bool = False, apply_scale: bool = True) -> Dict[str, np.ndarray]:
        Xs = self._t(self._prediction_coords(coords, apply_scale))
        with torch.no_grad():
            n = self.X.shape[0]
            K = self._gram(self.X, self.X) + self._val("raw_nv") * self._eye(n)
            L = torch.linalg.cholesky(K)
            Ks = self._gram(self.X, Xs)
            alpha = torch.cholesky_solve(self.Y[:, None], L)
            f_mean = (Ks.T @ alpha)[:, 0]
            v = torch.linalg.solve_triangular(L, Ks, upper=False)
            f_var = self._prior_var(Xs) - (v * v).sum(0)
            y_var = f_var + self._val("raw_nv")
            f_cov = self._gram(Xs, Xs) - v.T @ v if full_cov else None
        out = {"f*": self._numpy(f_mean), "f*_var": self._numpy(f_var), "y_var": self._numpy(y_var)}
        if full_cov:
            # ref gpytorch_models.py:169-177: f*_cov and y_cov (f_cov plus
            # the likelihood variance on the diagonal)
            self._attach_full_cov(out, self._numpy(f_cov), float(self._val("raw_nv")))
        return self._add_f_bar(out)

    # --- getters / setters ---
    def get_lengthscales(self):
        return self._numpy(self._val("raw_ls"))

    def get_kernel_variance(self):
        return float(self._val("raw_kv").detach())

    def get_likelihood_variance(self):
        return float(self._val("raw_nv").detach())

    def get_smoothness(self):
        return self.smoothness

    def _set_raw(self, attr, value):
        iv = self._intervals.get(attr)
        if iv is None:
            v = np.maximum(np.asarray(value, dtype=float), 1e-10)
            raw = np.log(np.expm1(v))
        else:
            low, high = (self._numpy(t) for t in iv)
            # inverse of low + (high - low) * sigmoid(raw), clipped just inside
            frac = (np.asarray(value, dtype=float) - low) / (high - low)
            frac = np.clip(frac, 1e-6, 1 - 1e-6)
            raw = np.log(frac / (1 - frac))
        with torch.no_grad():
            getattr(self, attr).copy_(self._t(raw))

    def _set_interval(self, attr, low, high, move_within_tol=True, tol=1e-8, scale=False, scale_magnitude=None):
        """Re-wrap a raw parameter with a sigmoid interval constraint, keeping
        its current value (ref: gpytorch_models.py:238-320 set_*_constraints
        + _preprocess_constraint)."""
        cur = self._numpy(self._val(attr))
        low = np.broadcast_to(np.asarray(low, dtype=float), np.shape(cur)).copy()
        high = np.broadcast_to(np.asarray(high, dtype=float), np.shape(cur)).copy()
        assert np.all(low <= high), f"constraint low > high for {attr}"
        if scale:
            s = self.coords_scale[0, :] if scale_magnitude is None else scale_magnitude
            low, high = low / s, high / s
        if move_within_tol:
            cur = np.clip(cur, low + tol, high - tol)
        self._intervals[attr] = (self._t(low), self._t(high))
        self._set_raw(attr, cur)

    def set_lengthscales_constraints(self, low, high, **kwargs):
        self._set_interval("raw_ls", low, high, **kwargs)

    def set_kernel_variance_constraints(self, low, high, **kwargs):
        self._set_interval("raw_kv", low, high, **kwargs)

    def set_likelihood_variance_constraints(self, low, high, **kwargs):
        self._set_interval("raw_nv", low, high, **kwargs)

    def set_lengthscales(self, v):
        self._set_raw("raw_ls", np.broadcast_to(np.atleast_1d(v), self.raw_ls.shape))

    def set_kernel_variance(self, v):
        self._set_raw("raw_kv", np.ravel(v)[0])

    def set_likelihood_variance(self, v):
        self._set_raw("raw_nv", np.ravel(v)[0])

    def set_smoothness(self, v):
        self.smoothness = float(v)


class TorchKISSGPModel(TorchGPRModel):
    """KISS-GP / SKI: K ~= W Kuu W^T on a uniform per-dimension grid
    (ref: GPSat/models/gpytorch_models.py:321-382, which wraps the base
    kernel in ScaleKernel(GridInterpolationKernel)).

    W holds multilinear interpolation weights of each data point onto the
    D-dimensional product grid (2^D nonzeros per row, stored dense: tiles
    are small); Kuu is the exact Matern Gram on the grid. The LML, the
    optimiser and predict are inherited: only the Gram and the prior
    variance are approximated, as gpytorch evaluates the interpolated
    kernel everywhere.
    """

    def __init__(self, *args, grid_size: int = 16, device=None, dtype=torch.float32, **kwargs):
        super().__init__(*args, device=device, dtype=dtype, **kwargs)
        self.grid_size = int(grid_size)
        D = self.X.shape[1]
        m = self.grid_size
        # per-dim uniform grid one spacing beyond the data range, so boundary
        # points interpolate rather than extrapolate (gpytorch's grid_bounds)
        grids = []
        for d in range(D):
            lo = float(self.X[:, d].min())
            hi = float(self.X[:, d].max())
            span = max(hi - lo, 1e-6)
            h = span / max(m - 3, 1)
            grids.append(torch.linspace(lo - h, hi + h, m, dtype=self.dtype, device=self.device))
        self._grids = grids
        # product grid points [M, D], M = m^D
        mesh = torch.meshgrid(*grids, indexing="ij")
        self._U = torch.stack([g.reshape(-1) for g in mesh], dim=1)

    def _interp_weights(self, X):
        """Multilinear interpolation weights [N, m^D] onto the product grid."""
        N, D = X.shape
        m = self.grid_size
        W = None
        for d in range(D):
            g = self._grids[d]
            h = g[1] - g[0]
            pos = (X[:, d] - g[0]) / h
            idx = pos.floor().long().clamp(0, m - 2)
            frac = (pos - idx.to(pos.dtype)).clamp(0.0, 1.0)
            wd = torch.zeros(N, m, dtype=self.dtype, device=self.device)
            wd.scatter_(1, idx[:, None], (1.0 - frac)[:, None])
            wd.scatter_add_(1, (idx + 1)[:, None], frac[:, None])
            W = wd if W is None else (W[:, :, None] * wd[:, None, :]).reshape(N, -1)
        return W

    def _gram(self, X1, X2):
        Kuu = super()._gram(self._U, self._U)
        return self._interp_weights(X1) @ Kuu @ self._interp_weights(X2).T

    def _prior_var(self, Xs):
        Kuu = super()._gram(self._U, self._U)
        W = self._interp_weights(Xs)
        return ((W @ Kuu) * W).sum(1)
