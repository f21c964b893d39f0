"""Sparse GPR (the Titsias 2009 collapsed bound), functional core batched
over B, and the host-facing single-expert model.

Port of ``gpsat_tpu/models/sgpr.py``: ``elbo``, ``neg_elbo``, ``predict``
(with ``full_cov``), ``pad_inducing_points``, ``make_sgpr_core`` and
``SGPRModel``, which evaluates the bound at B = 1. Data is ``{"X": [B, N, D], "y": [B, N], "mask": [B, N]}``;
params are dicts of [B, ...] tensors, the inducing points [B, M, D].

Masked tiles: padded observation rows have their Kuf columns zeroed, so they
drop out of every data-dependent term. Padded inducing slots (tiles with
n < M) sit far outside the data, where Kuf ~ 0 and Kuu is diagonal: they add
nothing to the bound or the posterior and keep M static per bucket.

Both factor pairs, (L, W) of Kuu and (LB, WB) of B = A A^T + I, come from
``ops/linalg.chol_winv_padded`` on the route ``factor`` names (kernel 1 on
the "block" route, the M-sized matrices identity-padded to a multiple of 64)
in every dtype: gradients flow through the pair's analytic pullback, and
every triangular solve is a matmul with W. The JAX package solves with
``cholesky`` + ``tri_solve`` in f64 instead: the same values at f64 roundoff.
An f64 Gram on the card takes the library arm of the route.

Large N: with ``chunk_size`` (``"auto"``: chunks of 4,096 once N >= 8,192)
the [M, N] matrices Kuf and A exist one [M, C] chunk at a time, accumulated
by a Python loop whose chunks run under ``torch.utils.checkpoint``
(``chunk_remat=True``: the backward recomputes each chunk's forward, so the
peak stays O(B M (M + C))); the factor pair of Kuu is computed once, outside
the loop, and no checkpoint recomputes it. Rematerialisation is an argument,
never an environment variable.

``accum_precision`` ("highest" by default, or "high"; an argument, the
port's stand-in for the environment variable the JAX package reads) sets the
precision of the chunked loop's products A_i = W Kuf_i and A_i A_i^T, as the
JAX core relaxes them in its chunked loop only (``ops/precision``): "high" is
the 3xTF32 product, the hand-written kernel ``csrc/mm3xtf32.cu`` on the
card, in the forward and in the checkpointed backward. The unchunked call,
the Gram's cross products, the factor pairs and the matrix-vector product
A_i ym_i stay true f32 at either level (the package keeps TF32 off).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gpsat_tpu_torch.models import means as MF
from gpsat_tpu_torch.models.base import lane_param_names
from gpsat_tpu_torch.models.gpr import GPRModel
from gpsat_tpu_torch.ops import kernels as K
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import precision as PR
from gpsat_tpu_torch.ops import transforms as T

PARAM_NAMES = ["lengthscales", "kernel_variance", "likelihood_variance", "inducing_points"]
DEFAULT_JITTER = 1e-6  # gpflow's default jitter on Kuu

# N from which "auto" accumulates the [M, N] factor chunk by chunk, and the chunk
CHUNK_THRESHOLD = 8192
DEFAULT_CHUNK = 4096


def _resolve_chunk(N: int, chunk_size) -> int:
    """0/None: never chunk; "auto": chunk when N >= CHUNK_THRESHOLD; an int
    forces that chunk size."""
    if chunk_size in (None, 0):
        return 0
    if chunk_size == "auto":
        return DEFAULT_CHUNK if N >= CHUNK_THRESHOLD else 0
    return int(chunk_size)


def _chunk_terms(Winv, Z, X, ym, m, ls, kv, sigma, kernel: str, level: str = "highest"):
    """One [M, C] chunk's share of A A^T [B, M, M], A ym [B, M, 1] and
    sum(ym^2) [B], with A = W Kuf / sigma; W Kuf and A A^T at ``level``
    (``ops/precision.accum_matmul``)."""
    Kuf = K.gram(kernel, Z, X, ls, kv) * m[:, None, :]
    A = PR.accum_matmul(Winv, Kuf, level) / sigma[:, None, None]
    AAT = PR.accum_matmul(A, A, level, transpose_b=True)
    return AAT, torch.matmul(A, ym[:, :, None]), torch.sum(ym * ym, dim=-1)


def _common_terms(cparams: dict, data: dict, *, kernel: str, jitter: float, chunk_size=None, factor: str = "block",
                  chunk_remat: bool = True, accum_precision: str = "highest") -> dict:
    """The factors the bound and the posterior share: (L, W) of Kuu,
    A A^T, A ym, (LB, WB) of B = A A^T + I, c = WB A ym / sigma, and the
    data sums n = sum(mask) and ymsq = sum(ym^2). ``accum_precision``
    applies to the chunked loop only."""
    level = PR.accum_precision(accum_precision)
    X, y, m = data["X"], data["y"], data["mask"].to(data["X"].dtype)
    # a trainable prior mean: the bound is taken on the centred observations
    if MF.has_mean(cparams):
        y = y - MF.mean_value(cparams, X)
    Z = cparams["inducing_points"]
    ls, kv = cparams["lengthscales"], cparams["kernel_variance"]
    sigma2 = cparams["likelihood_variance"]
    sigma = torch.sqrt(sigma2)

    Kuu = LA.add_diag(K.gram(kernel, Z, Z, ls, kv), jitter)
    L, Winv = LA.chol_winv_padded(Kuu, factor=factor)
    M, N = Z.shape[1], X.shape[1]
    ym = y * m
    C = _resolve_chunk(N, chunk_size)
    if C and N > C:
        remat = chunk_remat and torch.is_grad_enabled()
        AAT = Aerr = ymsq = 0.0
        for s in range(0, N, C):
            args = (Winv, Z, X[:, s : s + C], ym[:, s : s + C], m[:, s : s + C], ls, kv, sigma, kernel, level)
            part = checkpoint(_chunk_terms, *args, use_reentrant=False) if remat else _chunk_terms(*args)
            AAT, Aerr, ymsq = AAT + part[0], Aerr + part[1], ymsq + part[2]
    else:
        AAT, Aerr, ymsq = _chunk_terms(Winv, Z, X, ym, m, ls, kv, sigma, kernel)

    Bm = AAT + torch.eye(M, dtype=X.dtype, device=X.device)
    LB, WB = LA.chol_winv_padded(Bm, factor=factor)
    c = torch.matmul(WB, Aerr) / sigma[:, None, None]
    return dict(L=L, Winv=Winv, AAT=AAT, LB=LB, WB=WB, c=c, n=m.sum(-1), ymsq=ymsq, sigma2=sigma2, kv=kv)


def elbo(cparams: dict, data: dict, *, kernel: str, jitter: float = DEFAULT_JITTER, chunk_size=None,
         factor: str = "block", chunk_remat: bool = True, accum_precision: str = "highest") -> torch.Tensor:
    """Titsias collapsed evidence lower bound [B] of padded tiles."""
    t = _common_terms(cparams, data, kernel=kernel, jitter=jitter, chunk_size=chunk_size, factor=factor,
                      chunk_remat=chunk_remat, accum_precision=accum_precision)
    n, s2 = t["n"], t["sigma2"]
    out = -0.5 * n * math.log(2.0 * math.pi)
    out = out - torch.sum(torch.log(torch.diagonal(t["LB"], dim1=-2, dim2=-1)), dim=-1)
    out = out - 0.5 * n * torch.log(s2)
    out = out - 0.5 * t["ymsq"] / s2
    out = out + 0.5 * torch.sum(t["c"] ** 2, dim=(1, 2))
    # trace correction: -1/(2 s2) tr(Kff) + 1/2 tr(A A^T)
    out = out - 0.5 * n * t["kv"] / s2
    return out + 0.5 * torch.diagonal(t["AAT"], dim1=-2, dim2=-1).sum(-1)


def neg_elbo(uparams: dict, data: dict, *, kernel: str, bijectors: dict, jitter: float = DEFAULT_JITTER,
             chunk_size=None, factor: str = "block", chunk_remat: bool = True,
             accum_precision: str = "highest") -> torch.Tensor:
    p = T.forward_params(uparams, bijectors)
    return -elbo(p, data, kernel=kernel, jitter=jitter, chunk_size=chunk_size, factor=factor, chunk_remat=chunk_remat,
                 accum_precision=accum_precision)


def predict(cparams: dict, data: dict, Xnew: torch.Tensor, *, kernel: str, jitter: float = DEFAULT_JITTER,
            chunk_size=None, full_cov: bool = False, factor: str = "block", chunk_remat: bool = True,
            accum_precision: str = "highest") -> dict:
    """SGPR posterior mean and variance at Xnew [B, P, D] (gpflow's
    predict_f equations): f_mean, f_var, y_var [B, P], and f_cov [B, P, P]
    with ``full_cov``."""
    t = _common_terms(cparams, data, kernel=kernel, jitter=jitter, chunk_size=chunk_size, factor=factor,
                      chunk_remat=chunk_remat, accum_precision=accum_precision)
    Z, ls, kv = cparams["inducing_points"], cparams["lengthscales"], cparams["kernel_variance"]
    tmp1 = torch.matmul(t["Winv"], K.gram(kernel, Z, Xnew, ls, kv))
    tmp2 = torch.matmul(t["WB"], tmp1)
    f_mean = MF.add_mean(cparams, Xnew, torch.matmul(tmp2.transpose(1, 2), t["c"])[:, :, 0])
    f_var = K.gram_diag(kernel, Xnew, kv) + torch.sum(tmp2 * tmp2, dim=1) - torch.sum(tmp1 * tmp1, dim=1)
    out = {"f_mean": f_mean, "f_var": f_var, "y_var": f_var + cparams["likelihood_variance"][:, None]}
    if full_cov:
        Kss = K.gram(kernel, Xnew, Xnew, ls, kv)
        out["f_cov"] = Kss + torch.matmul(tmp2.transpose(1, 2), tmp2) - torch.matmul(tmp1.transpose(1, 2), tmp1)
    return out


def pad_inducing_points(Z: np.ndarray, M: int, data_span: float = 1.0) -> np.ndarray:
    """Pad an [m, D] inducing set to [M, D] with distinct far-away points.

    The pads start 100 spans beyond the largest coordinate, 10 spans apart:
    far enough that the kernel between a pad and the data (or another pad)
    is ~0 for lengthscales up to ~20 spans, near enough that the f32
    roundoff of |a|^2 + |b|^2 - 2ab (~|z|^2 eps) stays far below the pads'
    squared separations, so an f32 Kuu keeps its diagonal."""
    m, D = Z.shape
    if m >= M:
        return Z[:M]
    span = max(data_span, 1.0)
    far_base = Z.max(axis=0) if m else np.zeros(D)
    extra = np.arange(M - m, dtype=float)[:, None] * (10.0 * span)
    pad = far_base[None, :] + 100.0 * span + extra
    return np.concatenate([Z, pad], axis=0)


def draw_inducing_points(batch, M: int) -> np.ndarray:
    """Per-tile inducing points [B, M, D] of a TileBatch: a random subset of
    each tile's valid points (``np.random.default_rng(0)`` once per call,
    ``rng.choice(n, M, replace=False)`` per tile with n >= M, in tile order),
    the tiles with fewer points far-point padded (span = max|X| + 1): the
    JAX package's draw, number for number."""
    rng = np.random.default_rng(0)
    B, _, D = batch.X.shape
    span = float(np.max(np.abs(batch.X))) + 1.0
    Z = np.zeros((B, M, D), dtype=batch.X.dtype)
    for bi in range(B):
        n = int(batch.mask[bi].sum())
        pts = batch.X[bi, :n]
        if n >= M:
            Z[bi] = pts[rng.choice(n, M, replace=False)]
        else:
            Z[bi] = pad_inducing_points(pts, M, data_span=span)
    return Z


def prepare_inducing_init(batch, init: dict, M: int) -> dict:
    """``init`` with per-tile inducing points [B, M, D]: drawn by
    ``draw_inducing_points`` unless ``init`` already holds per-expert
    values, whose rows holding a NaN (an expert whose load found nothing)
    are drawn too. The sparse cores' ``prepare_batch_init``."""
    Z = init.get("inducing_points")
    if Z is not None and np.ndim(Z) == 3:
        missing = np.isnan(np.asarray(Z, dtype=float)).any(axis=(1, 2))
        if not missing.any():
            return init
        Z = np.where(missing[:, None, None], draw_inducing_points(batch, M), Z)
        return {**init, "inducing_points": Z}
    return {**init, "inducing_points": draw_inducing_points(batch, M)}


def make_sgpr_core(
    kernel: str = "Matern32",
    bijectors: Optional[dict] = None,
    jitter: float = DEFAULT_JITTER,
    num_inducing_points: int = 500,
    train_inducing_points: bool = False,
    mean_function: Optional[str] = None,
    chunk_size="auto",
    factor: str = "block",
    chunk_remat: bool = True,
    accum_precision: str = "highest",
):
    """SGPR core for the batched engine (objective = the negative bound).

    The inducing points ride in the params with the identity bijector and
    are held fixed unless ``train_inducing_points``. ``prepare_batch_init``
    draws them per tile (``prepare_inducing_init``).

    ``factor`` names the route of both factor pairs (ops/linalg.PAIR_ROUTES);
    ``chunk_size``, ``chunk_remat`` and ``accum_precision`` the large-N
    accumulation (module docstring)."""
    from gpsat_tpu_torch.models.functional import ModelCore

    if factor not in LA.PAIR_ROUTES:
        raise ValueError(f"factor must be one of {LA.PAIR_ROUTES}, got {factor!r}")
    MF.validate(mean_function)
    if bijectors is None:
        bijectors = {name: T.POSITIVE for name in PARAM_NAMES}
    bijectors = dict(bijectors)
    bijectors["inducing_points"] = T.IDENTITY
    for p in MF.mean_param_names(mean_function):
        bijectors.setdefault(p, T.IDENTITY)
    M = int(num_inducing_points)
    kw = dict(kernel=kernel, jitter=jitter, chunk_size=chunk_size, factor=factor, chunk_remat=chunk_remat,
              accum_precision=PR.accum_precision(accum_precision))

    def objective(uparams, data):
        return neg_elbo(uparams, data, bijectors=bijectors, **kw)

    def predict_fn(cparams, data, Xnew):
        return predict(cparams, data, Xnew, **kw)

    def forward(uparams):
        return {k: bijectors[k].forward(v) for k, v in uparams.items()}

    def inverse(cparams):
        return {k: bijectors[k].inverse(torch.as_tensor(v)) for k, v in cparams.items()}

    def init_cparams(D: int, dtype=np.float64, overrides: Optional[dict] = None) -> Dict[str, np.ndarray]:
        out = {
            "lengthscales": np.ones((D,), dtype=dtype),
            "kernel_variance": np.asarray(1.0, dtype=dtype),
            "likelihood_variance": np.asarray(1.0, dtype=dtype),
            "inducing_points": np.zeros((M, D), dtype=dtype),
        }
        out.update(MF.mean_param_defaults(mean_function, D, dtype=dtype))
        for k, v in (overrides or {}).items():
            if k in out:
                v = np.asarray(v, dtype=dtype)
                out[k] = np.broadcast_to(v, out[k].shape).copy() if v.shape != out[k].shape else v
        return out

    return ModelCore(
        name=f"SGPR[{kernel},M={M}]",
        objective=objective,
        predict=predict_fn,
        forward=forward,
        inverse=inverse,
        init_cparams=init_cparams,
        param_names=tuple(PARAM_NAMES) + MF.mean_param_names(mean_function),
        default_fixed_params=() if train_inducing_points else ("inducing_points",),
        prepare_batch_init=functools.partial(prepare_inducing_init, M=M),
    )


class SGPRModel(GPRModel):
    """Sparse GPR on one expert (the reference's GPflowSGPRModel contract;
    gpsat_tpu/models/sgpr.py::SGPRModel): ``num_inducing_points`` (default
    500) inducing points, a random subset of the data drawn with
    ``np.random.shuffle`` as the JAX class draws them (all the data when it
    has fewer points, ref: gpflow_models.py:804-819); the objective the
    collapsed bound, fixed inducing points unless ``train_inducing_points``.
    ``get_objective_function_value`` is the bound itself, not negated (ref:
    :860-862). Both factor pairs (Kuu and B) go through kernel 1 in f32 on
    the card."""

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
        num_inducing_points: int = 500,
        kernel_kwargs: Optional[dict] = None,
        noise_variance: Optional[float] = None,
        jitter: float = DEFAULT_JITTER,
        chunk_size="auto",
        device=None,
        dtype=torch.float64,
        **kwargs,
    ):
        self.chunk_size = chunk_size
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
            kernel=kernel,
            kernel_kwargs=kernel_kwargs,
            noise_variance=noise_variance,
            jitter=jitter,
            device=device,
            dtype=dtype,
            **kwargs,
        )
        assert num_inducing_points is not None, "num_inducing_points must be specified for SGPR"
        Z = np.array(self.coords, copy=True)
        if len(Z) >= num_inducing_points:
            np.random.shuffle(Z)
            Z = Z[:num_inducing_points]
        self._params["inducing_points"] = Z
        self._bijectors["inducing_points"] = T.IDENTITY

    def _bound(self, cparams: dict, data: dict) -> torch.Tensor:
        return elbo(cparams, data, kernel=self.kernel, jitter=self.jitter, chunk_size=self.chunk_size)

    def optimise_parameters(self, train_inducing_points: bool = False, max_iter: int = 10_000, fixed_params=None,
                            **opt_kwargs) -> bool:
        fixed_params = list(fixed_params or [])
        if not train_inducing_points and "inducing_points" not in fixed_params:
            fixed_params.append("inducing_points")
        data = self._data_dict()
        return self._minimize(lambda c: -self._bound(c, data), fixed_params, max_iter, **opt_kwargs)

    def get_objective_function_value(self) -> float:
        """The collapsed bound (not negated, as the reference's SGPR)."""
        with torch.no_grad():
            return float(self._bound(self._cparams(), self._data_dict())[0])

    def predict(self, coords, full_cov: bool = False, apply_scale: bool = True) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            pred = predict(self._cparams(), self._data_dict(), self._prediction_tensor(coords, apply_scale),
                           kernel=self.kernel, jitter=self.jitter, chunk_size=self.chunk_size, full_cov=full_cov)
        return self._prediction_out(pred, full_cov)

    def get_inducing_points(self) -> np.ndarray:
        return np.asarray(self._params["inducing_points"])

    def set_inducing_points(self, inducing_points):
        self._params["inducing_points"] = np.asarray(inducing_points, dtype=float)
