"""ASVGP: actually sparse variational GP with B-spline inducing features,
batched over B, and the host-facing single-expert model.

Port of ``gpsat_tpu/models/asvgp.py``: the bases ``hat_basis_eval``,
``b2_basis`` and ``b3_basis``, the banded RKHS Grams
``matern{12,32,52}_spline_kuu``, ``elbo``, ``predict`` (with ``full_cov``),
``make_asvgp_core`` and ``ASVGPModel`` (the bound at B = 1). Data is ``{"X": [B, N, D], "y": [B, N], "mask":
[B, N]}``; params are dicts of [B, ...] tensors, the per-tile uniform knot
grids [B, D, M] among them.

Kernel / spline pairs (``SPLINE_PAIRS``): Matern12 with the hat basis (B1,
M features per dimension), Matern32 with quadratic B-splines (B2, M + 1)
and Matern52 with cubic ones (B3, M + 2). Kuf is the basis evaluated at the
data; Kuu is the basis' banded Gram under the kernel's RKHS inner product
on [a, b], assembled by exact Gauss-Legendre quadrature (3 points for B2, 4
for B3; closed form for B1) with the boundary terms of each pair.

The collapsed bound and posterior are VFF's, on the Kronecker product of
the per-dimension features (``vff.collapsed_terms``): P's factor pair comes
from ``ops/linalg.chol_winv_padded`` (kernel 1 on the "block" route in f32
on the card).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from gpsat_tpu_torch.models import means as MF
from gpsat_tpu_torch.models.base import TorchCoreModel, lane_param_names
from gpsat_tpu_torch.models.vff import (
    masked_range,
    collapsed_elbo,
    collapsed_predict,
    collapsed_terms,
    keep_or_fill,
    make_kvs,
    per_dim_params,
)
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import transforms as T

PARAM_NAMES = ["lengthscales", "kernel_variance", "likelihood_variance"]


def _spacing(knots: torch.Tensor):
    """First knot a and uniform spacing h [B] of knot grids [B, M]."""
    return knots[:, 0], knots[:, 1] - knots[:, 0]


def hat_basis_eval(x: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """B1 (hat) basis at x [B, N]: [B, M, N], M = knots per grid."""
    _, h = _spacing(knots)
    d = torch.abs(x[:, None, :] - knots[:, :, None]) / h[:, None, None]
    return torch.clamp_min(1.0 - d, 0.0)


def _knot_units(x: torch.Tensor, knots: torch.Tensor, order: int) -> torch.Tensor:
    """t [B, M + order - 1, N]: x in knot units relative to the support of
    each basis function B((x - a)/h - (i - order))."""
    a, h = _spacing(knots)
    i = torch.arange(knots.shape[-1] - 1 + order, dtype=x.dtype, device=x.device)
    return (x[:, None, :] - a[:, None, None]) / h[:, None, None] - (i[None, :, None] - order)


def _piecewise(t: torch.Tensor, polys, width: int) -> torch.Tensor:
    """sum over unit segments [k, k + 1) of t (the last one closed) of
    polys[k] there, 0 outside [0, width]."""
    v = torch.zeros_like(t)
    for k, p in enumerate(polys):
        seg = (t >= k) & ((t <= width) if k == width - 1 else (t < k + 1))
        v = torch.where(seg, p, v)
    return v


def b2_basis(x: torch.Tensor, knots: torch.Tensor, deriv: int = 0) -> torch.Tensor:
    """Quadratic (B2, C^1) spline basis on a uniform grid: [B, M + 1, N], or
    its first or second derivative (the latter piecewise constant)."""
    _, h = _spacing(knots)
    t = _knot_units(x, knots, 2)
    if deriv == 0:
        return _piecewise(t, [0.5 * t**2, 0.5 * (-2 * t**2 + 6 * t - 3), 0.5 * (3 - t) ** 2], 3)
    one = torch.ones_like(t)
    if deriv == 1:
        return _piecewise(t, [t, -2 * t + 3, t - 3], 3) / h[:, None, None]
    if deriv == 2:
        return _piecewise(t, [one, -2.0 * one, one], 3) / h[:, None, None] ** 2
    raise ValueError(f"deriv: {deriv}")


def b3_basis(x: torch.Tensor, knots: torch.Tensor, deriv: int = 0) -> torch.Tensor:
    """Cubic (B3, C^2) spline basis on a uniform grid: [B, M + 2, N], or
    its derivatives up to the third."""
    _, h = _spacing(knots)
    t = _knot_units(x, knots, 3)
    if deriv == 0:
        polys = [t**3 / 6, (-3 * t**3 + 12 * t**2 - 12 * t + 4) / 6, (3 * t**3 - 24 * t**2 + 60 * t - 44) / 6,
                 (4 - t) ** 3 / 6]
    elif deriv == 1:
        polys = [t**2 / 2, (-9 * t**2 + 24 * t - 12) / 6, (9 * t**2 - 48 * t + 60) / 6, -((4 - t) ** 2) / 2]
    elif deriv == 2:
        polys = [t, -3 * t + 4, 3 * t - 8, 4 - t]
    elif deriv == 3:
        one = torch.ones_like(t)
        polys = [one, -3 * one, 3 * one, -one]
    else:
        raise ValueError(f"deriv: {deriv}")
    return _piecewise(t, polys, 4) / h[:, None, None] ** deriv


def _tridiag(main: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(main) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)


def matern12_spline_kuu(knots: torch.Tensor, lengthscale, variance) -> torch.Tensor:
    """Tridiagonal RKHS Gram [B, M, M] of the hat basis under Matern12:
    (mass / l + l stiffness + the end points' terms) / (2 s2)."""
    _, h = _spacing(knots)
    M = knots.shape[-1]
    edge = torch.ones(M, dtype=knots.dtype, device=knots.device)
    edge[1:-1] = 2.0  # interior rows carry two intervals
    h_ = h[:, None]
    mass = _tridiag(edge * h_ / 3.0, (h_ / 6.0).expand(-1, M - 1))
    stiff = _tridiag(edge / h_, (-1.0 / h_).expand(-1, M - 1))
    ends = torch.zeros(M, dtype=knots.dtype, device=knots.device)
    ends[0] = ends[-1] = 1.0
    ls = lengthscale[:, None, None]
    return (mass / ls + ls * stiff + torch.diag(ends)) / (2.0 * variance[:, None, None])


def _quadrature(knots: torch.Tensor, nodes: np.ndarray, weights: np.ndarray):
    """Gauss-Legendre points [B, Q] and weights [B, Q] on every knot
    interval, from nodes and weights on [0, 1]."""
    _, h = _spacing(knots)
    gl_x = torch.as_tensor(nodes, dtype=knots.dtype, device=knots.device)
    gl_w = torch.as_tensor(weights, dtype=knots.dtype, device=knots.device)
    xq = (knots[:, :-1, None] + gl_x[None, None, :] * h[:, None, None]).reshape(knots.shape[0], -1)
    return xq, gl_w.repeat(knots.shape[-1] - 1)[None, :] * h[:, None]


def _weighted_gram(F: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """sum_q w_q F[:, i, q] F[:, j, q]: [B, M, M]."""
    return torch.matmul(F * wq[:, None, :], F.transpose(1, 2))


def _sym_outer(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u v^T + v u^T of [B, M] vectors."""
    return u[:, :, None] * v[:, None, :] + v[:, :, None] * u[:, None, :]


def matern32_spline_kuu(knots: torch.Tensor, lengthscale, variance) -> torch.Tensor:
    """Banded RKHS Gram [B, M + 1, M + 1] of the B2 basis under Matern32
    (lam = sqrt(3)/l, C = 1 / (4 lam^3 s2)):

      <f, g> = C [ int f''g'' + 2 lam^2 f'g' + lam^4 f g
                   + 2 lam^3 (fg)(a) + 2 lam (f'g')(a) - lam^2 (fg' + f'g)(a)
                   + 2 lam^3 (fg)(b) + 2 lam (f'g')(b) + lam^2 (fg' + f'g)(b) ]

    The integrands are degree <= 4 per interval: 3-point Gauss-Legendre is
    exact."""
    lam = (math.sqrt(3.0) / lengthscale)[:, None, None]
    r = np.sqrt(15) / 10
    xq, wq = _quadrature(knots, np.array([0.5 - r, 0.5, 0.5 + r]), np.array([5.0, 8.0, 5.0]) / 18)
    integ = (_weighted_gram(b2_basis(xq, knots, 2), wq) + 2.0 * lam**2 * _weighted_gram(b2_basis(xq, knots, 1), wq)
             + lam**4 * _weighted_gram(b2_basis(xq, knots, 0), wq))
    ends = knots[:, [0, -1]]
    V, Dv = b2_basis(ends, knots, 0), b2_basis(ends, knots, 1)
    va, vb, da, db = V[..., 0], V[..., 1], Dv[..., 0], Dv[..., 1]
    bnd = (lam**3 * (_sym_outer(va, va) + _sym_outer(vb, vb)) + lam * (_sym_outer(da, da) + _sym_outer(db, db))
           - lam**2 * _sym_outer(va, da) + lam**2 * _sym_outer(vb, db))
    return (integ + bnd) / (4.0 * lam**3 * variance[:, None, None])


def matern52_spline_kuu(knots: torch.Tensor, lengthscale, variance) -> torch.Tensor:
    """Banded RKHS Gram [B, M + 2, M + 2] of the B3 basis under Matern52
    (lam = sqrt(5)/l, C = 3 / (16 lam^5 s2)):

      <f, g> = C [ int f'''g''' + 3 lam^2 f''g'' + 3 lam^4 f'g' + lam^6 fg
                   + at each end p in {a, b} (s = -1 at a, +1 at b):
                     3 lam^5 fg + 8 lam^3 f'g' + 3 lam f''g''
                     + 3 s lam^4 (fg' + f'g) + lam^3 (fg'' + f''g)
                     + 3 s lam^2 (f'g'' + f''g') ]

    The integrands are degree <= 6 per interval: 4-point Gauss-Legendre is
    exact."""
    lam = (math.sqrt(5.0) / lengthscale)[:, None, None]
    r1 = np.sqrt(3.0 / 7.0 - 2.0 / 7.0 * np.sqrt(6.0 / 5.0))
    r2 = np.sqrt(3.0 / 7.0 + 2.0 / 7.0 * np.sqrt(6.0 / 5.0))
    w1, w2 = (18.0 + np.sqrt(30.0)) / 72.0, (18.0 - np.sqrt(30.0)) / 72.0
    xq, wq = _quadrature(knots, 0.5 + 0.5 * np.array([-r2, -r1, r1, r2]), np.array([w2, w1, w1, w2]))
    integ = (_weighted_gram(b3_basis(xq, knots, 3), wq) + 3.0 * lam**2 * _weighted_gram(b3_basis(xq, knots, 2), wq)
             + 3.0 * lam**4 * _weighted_gram(b3_basis(xq, knots, 1), wq)
             + lam**6 * _weighted_gram(b3_basis(xq, knots, 0), wq))
    ends = knots[:, [0, -1]]
    V, Dv, D2v = (b3_basis(ends, knots, d) for d in (0, 1, 2))
    bnd = torch.zeros_like(integ)
    for col, sign in ((0, -1.0), (1, 1.0)):
        v, dv, d2 = V[..., col], Dv[..., col], D2v[..., col]
        bnd = bnd + (
            1.5 * lam**5 * _sym_outer(v, v) + 4.0 * lam**3 * _sym_outer(dv, dv) + 1.5 * lam * _sym_outer(d2, d2)
            + 3.0 * sign * lam**4 * _sym_outer(v, dv) + lam**3 * _sym_outer(v, d2)
            + 3.0 * sign * lam**2 * _sym_outer(dv, d2)
        )
    return 3.0 * (integ + bnd) / (16.0 * lam**5 * variance[:, None, None])


SPLINE_PAIRS = {
    # kernel -> (basis at x [B, N] on knots [B, M] -> [B, Mb, N], its Gram)
    "Matern12": (hat_basis_eval, matern12_spline_kuu),
    "Matern32": (lambda x, kn: b2_basis(x, kn, 0), matern32_spline_kuu),
    "Matern52": (lambda x, kn: b3_basis(x, kn, 0), matern52_spline_kuu),
}
# basis functions per knot grid of M knots, minus M
EXTRA_FEATURES = {"Matern12": 0, "Matern32": 1, "Matern52": 2}


def _factors(cparams: dict, data: dict, knots: torch.Tensor, *, kernel: str, factor: str = "block") -> dict:
    """``vff.collapsed_terms`` of the spline features on knots [B, D, M]."""
    D = data["X"].shape[-1]
    ls, var_d = per_dim_params(cparams, D)
    basis_eval, kuu_fn = SPLINE_PAIRS[kernel]
    Kuf_dims = [basis_eval(data["X"][:, :, i], knots[:, i]) for i in range(D)]
    Kuu_dims = [kuu_fn(knots[:, i], ls[:, i], var_d) for i in range(D)]
    return collapsed_terms(cparams, data, Kuf_dims, Kuu_dims, factor=factor)


def elbo(cparams: dict, data: dict, knots_list: torch.Tensor, kernel: str = "Matern12", factor: str = "block"):
    """The collapsed ASVGP bound [B] of padded tiles; ``knots_list`` holds
    each tile's knots per dimension, [B, D, M]."""
    t = _factors(cparams, data, knots_list, kernel=kernel, factor=factor)
    return collapsed_elbo(t, cparams["kernel_variance"])


def predict(cparams: dict, data: dict, Xnew: torch.Tensor, knots_list: torch.Tensor, kernel: str = "Matern12",
            full_cov: bool = False, factor: str = "block") -> dict:
    """ASVGP posterior at Xnew [B, P, D]: f_mean, f_var, y_var [B, P], and
    f_cov [B, P, P] (the separable product prior, as VFF's) with
    ``full_cov``; ``knots_list`` as ``elbo``'s."""
    t = _factors(cparams, data, knots_list, kernel=kernel, factor=factor)
    basis_eval, _ = SPLINE_PAIRS[kernel]
    Kus = make_kvs([basis_eval(Xnew[:, :, i], knots_list[:, i]) for i in range(Xnew.shape[-1])])
    return collapsed_predict(cparams, t, Kus, Xnew, kernel, full_cov)


def make_asvgp_core(
    kernel: str = "Matern12",
    bijectors: Optional[dict] = None,
    num_inducing_features: int = 20,
    margin=0.1,
    mean_function: Optional[str] = None,
    factor: str = "block",
):
    """ASVGP core for the batched engine (objective = the negative bound).

    The per-tile knot grids [B, D, M] are a fixed parameter with the
    identity bijector (the SGPR inducing-point pattern):
    ``prepare_batch_init`` lays a uniform grid of M knots per dimension over
    each tile's masked coordinate range +- ``margin`` (scaled units), and
    keeps per-expert grids already in the init (loaded, or the fit's own in
    the polish). ``factor`` names the route of P's factor pair."""
    from gpsat_tpu_torch.models.functional import ModelCore

    if kernel not in SPLINE_PAIRS:
        raise ValueError(f"kernel {kernel!r} not in {sorted(SPLINE_PAIRS)}")
    if factor not in LA.PAIR_ROUTES:
        raise ValueError(f"factor must be one of {LA.PAIR_ROUTES}, got {factor!r}")
    MF.validate(mean_function)
    mean_names = MF.mean_param_names(mean_function)
    M = int(num_inducing_features)
    bij = {name: T.POSITIVE for name in PARAM_NAMES}
    if bijectors:
        bij.update(bijectors)
    bij["knots"] = T.IDENTITY
    for p in mean_names:
        bij.setdefault(p, T.IDENTITY)

    def forward(uparams):
        return {k: bij[k].forward(v) for k, v in uparams.items()}

    def inverse(cparams):
        return {k: bij[k].inverse(torch.as_tensor(v)) for k, v in cparams.items()}

    def objective(uparams, data):
        c = forward(uparams)
        return -elbo(c, data, c["knots"], kernel, factor=factor)

    def predict_fn(cparams, data, Xnew):
        return predict(cparams, data, Xnew, cparams["knots"], kernel, factor=factor)

    def init_cparams(D: int, dtype=np.float64, overrides: Optional[dict] = None) -> Dict[str, np.ndarray]:
        out = {
            "lengthscales": np.ones(D, dtype=dtype),
            "kernel_variance": np.asarray(1.0, dtype=dtype),
            "likelihood_variance": np.asarray(1.0, dtype=dtype),
            # a unit grid: a lane padded with the defaults stays finite
            "knots": np.tile(np.linspace(0.0, 1.0, M, dtype=dtype), (D, 1)),
        }
        out.update(MF.mean_param_defaults(mean_function, D, dtype=dtype))
        for k, v in (overrides or {}).items():
            if k in out and k != "knots":
                out[k] = np.broadcast_to(np.asarray(v, dtype=dtype), np.shape(out[k])).copy()
        return out

    def knot_grids(batch) -> np.ndarray:
        mg = np.asarray(margin, dtype=float).reshape(-1)
        lo, hi = masked_range(np.asarray(batch.X), batch.mask)
        lo, hi = lo - mg, hi + mg
        bad = ~np.isfinite(lo) | ~np.isfinite(hi)  # dead tiles: a harmless unit domain
        lo, hi = np.where(bad, 0.0, lo), np.where(bad, 1.0, hi)
        return lo[..., None] + (hi - lo)[..., None] * np.linspace(0.0, 1.0, M)[None, None, :]

    def prepare_batch_init(batch, init):
        return keep_or_fill(init, "knots", lambda: knot_grids(batch))

    return ModelCore(
        name=f"asvgp_{kernel}",
        objective=objective,
        predict=predict_fn,
        forward=forward,
        inverse=inverse,
        init_cparams=init_cparams,
        param_names=("lengthscales", "kernel_variance", "likelihood_variance", "knots") + mean_names,
        default_fixed_params=("knots",),
        prepare_batch_init=prepare_batch_init,
        num_features=lambda D: (M + EXTRA_FEATURES[kernel]) ** D,
    )


class ASVGPModel(TorchCoreModel):
    """ASVGP on one expert (gpsat_tpu/models/asvgp.py::ASVGPModel): Matern12
    with the hat basis by default (Matern32 / B2 and Matern52 / B3 too), a
    uniform grid of ``num_inducing_features`` knots per dimension over the
    data's range +- ``margin`` (scaled units, per dimension or shared). The
    objective is the collapsed bound; P's factor pair goes through kernel 1
    in f32 on the card."""

    PARAM_NAMES = tuple(PARAM_NAMES)
    param_names = lane_param_names((*PARAM_NAMES, "knots"))

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
        kernel: str = "Matern12",
        num_inducing_features: Optional[int] = None,
        domain_size=None,
        expert_loc=None,
        noise_variance: Optional[float] = None,
        margin=0.1,
        device=None,
        dtype=torch.float64,
        **kwargs,
    ):
        self._init_device(device, dtype)
        mean_function = MF.validate(kwargs.pop("mean_function", None))
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
        assert kernel in SPLINE_PAIRS, (
            f"ASVGP implements the Matern12/B1, Matern32/B2 and Matern52/B3 spline pairs; got kernel={kernel!r} "
            "— use VFF or SGPR for other kernels"
        )
        assert num_inducing_features is not None, "num_inducing_features must be specified"
        self.kernel = kernel
        D = self.coords.shape[1]
        M = int(num_inducing_features)
        margin = np.broadcast_to(np.asarray(margin, dtype=float).reshape(-1), (D,))
        lo, hi = self.coords.min(axis=0) - margin, self.coords.max(axis=0) + margin
        self.knots_list = [np.linspace(lo[i], hi[i], M) for i in range(D)]
        self._init_gpr_params(np.ones(D), 1.0, noise_variance, mean_function)

    def _knots(self) -> torch.Tensor:
        return self._tensor(np.stack(self.knots_list))[None]

    def get_objective_function_value(self) -> float:
        """The collapsed bound."""
        with torch.no_grad():
            return float(elbo(self._cparams(), self._data_dict(), self._knots(), self.kernel)[0])

    def optimise_parameters(self, max_iter: int = 10_000, fixed_params=None, **opt_kwargs) -> bool:
        data, knots = self._data_dict(), self._knots()
        return self._minimize(lambda c: -elbo(c, data, knots, self.kernel), list(fixed_params or []), max_iter,
                              **opt_kwargs)

    def predict(self, coords, full_cov: bool = False, apply_scale: bool = True) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            pred = predict(self._cparams(), self._data_dict(), self._prediction_tensor(coords, apply_scale),
                           self._knots(), self.kernel, full_cov=full_cov)
        return self._prediction_out(pred, full_cov)

    def set_lengthscales(self, v):
        ls = np.atleast_1d(np.asarray(v, dtype=float))
        self._params["lengthscales"] = np.full(self.coords.shape[1], ls[0]) if len(ls) == 1 else ls
