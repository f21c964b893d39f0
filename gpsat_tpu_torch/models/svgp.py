"""SVGP (Hensman et al. 2013), whitened, functional core batched over B, and
the host-facing single-expert model.

Port of ``gpsat_tpu/models/svgp.py``: ``SVGPModel`` (at B = 1) and
``variational_expectations`` (Gaussian, StudentT, Bernoulli, Poisson), the
q(f) marginals, ``kl_whitened``, ``elbo`` (minibatch, mean function,
checkpointed chunks), ``predict`` (with ``full_cov``), ``collapsed_q``,
``natgrad_step`` and ``make_svgp_core`` with its three solvers. Data is
``{"X": [B, N, D], "y": [B, N], "mask": [B, N]}``; params are dicts of
[B, ...] tensors: inducing_points [B, M, D], inducing_mean [B, M],
inducing_chol [B, M, M] (lower triangle used; the upper one is kept as
given and ignored).

Whitened representation (gpflow's default): u = Luu v, q(v) = N(q_mu, S),
S = q_sqrt q_sqrt^T. ELBO = (N / n_batch) sum_batch E_q[log p(y_n | f_n)] -
KL(q(v) || N(0, I)).

The factor pair (L, W = L^-1) of Kuu comes from the differentiable
``ops/linalg.chol_winv_padded`` on the "block" route (kernel 1 for an f32
tile on the card) in every dtype, and every
whitening solve is a matmul with W; the collapsed bound and ``collapsed_q``
take both of theirs (Kuu and B = I + A A^T) from ``sgpr._common_terms`` the
same way. The JAX package solves with ``cholesky`` + ``tri_solve`` in f64:
the same values at f64 roundoff. The small M x M factors of q itself
(``collapsed_q``, ``natgrad_step``) are plain ``torch.linalg`` Cholesky
factors, NaN where the matrix is not positive definite, as
``jnp.linalg.cholesky`` gives them.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gpsat_tpu_torch.models import means as MF
from gpsat_tpu_torch.models import sgpr as SG
from gpsat_tpu_torch.models.base import lane_param_names
from gpsat_tpu_torch.models.gpr import GPRModel
from gpsat_tpu_torch.ops import kernels as K
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import precision as PR
from gpsat_tpu_torch.ops import transforms as T

PARAM_NAMES = [
    "lengthscales",
    "kernel_variance",
    "likelihood_variance",
    "inducing_points",
    "inducing_mean",
    "inducing_chol",
]
DEFAULT_JITTER = 1e-6
LIKELIHOODS = ("Gaussian", "StudentT", "Bernoulli", "Poisson")

# probabilists' Gauss-Hermite rule: E_{N(0,1)}[f] ~= sum_i w_i f(x_i); 50
# nodes, as the JAX package takes them for StudentT and Bernoulli
_GH_X, _GH_W = np.polynomial.hermite_e.hermegauss(50)
_GH_W = _GH_W / np.sqrt(2 * np.pi)


def _gh_nodes(like: torch.Tensor):
    """The quadrature nodes and weights in the compute dtype and device."""
    return (torch.as_tensor(_GH_X, dtype=like.dtype, device=like.device),
            torch.as_tensor(_GH_W, dtype=like.dtype, device=like.device))


def _cholesky(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of [B, M, M], NaN where S is not positive
    definite (``jnp.linalg.cholesky``'s answer; ``torch.linalg.cholesky``
    would raise). Differentiable."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info > 0)[:, None, None], torch.full_like(L, float("nan")), L)


def variational_expectations(likelihood: str, y, f_mean, f_var, lik_params: dict):
    """E_{N(f | f_mean, f_var)}[log p(y | f)] per data point, [B, N];
    ``lik_params["variance"]`` is [B]."""
    if likelihood == "Gaussian":
        s2 = lik_params["variance"][:, None]
        return -0.5 * torch.log(2 * math.pi * s2) - 0.5 * ((y - f_mean) ** 2 + f_var) / s2
    if likelihood == "StudentT":
        df = torch.as_tensor(lik_params.get("df", 3.0), dtype=f_mean.dtype, device=f_mean.device)
        scale = torch.sqrt(lik_params["variance"])[:, None, None]
        # 50 nodes: ~4e-4 quadrature error even for peaky heavy-tailed
        # integrands (gpflow's default 20 leaves ~5e-3)
        x, w = _gh_nodes(f_mean)
        f = f_mean[..., None] + torch.sqrt(torch.clamp_min(f_var, 1e-30))[..., None] * x
        z = (y[..., None] - f) / scale
        logp = (
            torch.lgamma((df + 1) / 2)
            - torch.lgamma(df / 2)
            - 0.5 * torch.log(df * math.pi)
            - torch.log(scale)
            - (df + 1) / 2 * torch.log1p(z**2 / df)
        )
        return torch.matmul(logp, w)
    if likelihood == "Bernoulli":
        # probit link (gpflow's Bernoulli default); y in {0, 1} or {-1, +1}
        ys = torch.where(y > 0, torch.ones_like(y), -torch.ones_like(y))
        x, w = _gh_nodes(f_mean)
        f = f_mean[..., None] + torch.sqrt(torch.clamp_min(f_var, 1e-30))[..., None] * x
        return torch.matmul(torch.special.log_ndtr(ys[..., None] * f), w)
    if likelihood == "Poisson":
        # exp link: E[log p] = y E[f] - E[exp f] - log y!, E[exp f] closed-form
        return y * f_mean - torch.exp(f_mean + 0.5 * f_var) - torch.lgamma(y + 1.0)
    raise NotImplementedError(f"likelihood: {likelihood} not implemented (use one of {LIKELIHOODS})")


def _marginals_given_L(cparams: dict, LW, X: torch.Tensor, *, kernel: str, return_factors: bool = False):
    """q(f) marginals [B, N] at X given the Kuu factor pair (L, W = L^-1);
    ``return_factors`` also yields A = W Kus and SA = q_sqrt^T A for a full
    covariance."""
    _, W = LW
    Z = cparams["inducing_points"]
    ls, kv = cparams["lengthscales"], cparams["kernel_variance"]
    q_mu = cparams["inducing_mean"]
    q_sqrt = torch.tril(cparams["inducing_chol"])
    A = torch.matmul(W, K.gram(kernel, Z, X, ls, kv))  # [B, M, N]
    f_mean = torch.matmul(A.transpose(1, 2), q_mu[..., None])[..., 0]
    SA = torch.matmul(q_sqrt.transpose(1, 2), A)
    f_var = K.gram_diag(kernel, X, kv) - torch.sum(A * A, dim=1) + torch.sum(SA * SA, dim=1)
    f_var = torch.clamp_min(f_var, 1e-30)
    if return_factors:
        return f_mean, f_var, A, SA
    return f_mean, f_var


def _chol_Kuu(cparams: dict, *, kernel: str, jitter: float):
    """(L, W = L^-1) of Kuu + jitter I by ``linalg.chol_winv_padded``."""
    Z = cparams["inducing_points"]
    Kuu = LA.add_diag(K.gram(kernel, Z, Z, cparams["lengthscales"], cparams["kernel_variance"]), jitter)
    return LA.chol_winv_padded(Kuu)


def _whitened_marginals(cparams: dict, X: torch.Tensor, *, kernel: str, jitter: float):
    LW = _chol_Kuu(cparams, kernel=kernel, jitter=jitter)
    return _marginals_given_L(cparams, LW, X, kernel=kernel)


def kl_whitened(q_mu: torch.Tensor, q_sqrt: torch.Tensor) -> torch.Tensor:
    """KL(N(q_mu, S) || N(0, I)) [B], S = tril(q_sqrt) tril(q_sqrt)^T; the
    log-determinant takes log|diag| so a free triangle is safe."""
    Lq = torch.tril(q_sqrt)
    M = q_mu.shape[-1]
    diag = torch.diagonal(Lq, dim1=-2, dim2=-1)
    return 0.5 * (torch.sum(q_mu**2, -1) + torch.sum(Lq**2, dim=(-2, -1)) - M
                  - 2.0 * torch.sum(torch.log(torch.abs(diag)), -1))


def _chunk_lik_sum(L, W, Z, ls, kv, q_mu, q_chol, lv, X, y, m, kernel: str, likelihood: str):
    """One chunk's sum of E_q[log p] over its valid rows, [B]."""
    cp = {"inducing_points": Z, "lengthscales": ls, "kernel_variance": kv, "inducing_mean": q_mu,
          "inducing_chol": q_chol}
    fm, fv = _marginals_given_L(cp, (L, W), X, kernel=kernel)
    return torch.sum(variational_expectations(likelihood, y, fm, fv, {"variance": lv}) * m, -1)


def elbo(
    cparams: dict,
    data: dict,
    *,
    kernel: str,
    likelihood: str = "Gaussian",
    jitter: float = DEFAULT_JITTER,
    batch_idx: Optional[torch.Tensor] = None,
    chunk_size=None,
) -> torch.Tensor:
    """Minibatch ELBO [B] of padded tiles. ``batch_idx`` ([n] shared, or
    [B, n] per tile) selects the minibatch (the full tile if None); padded
    rows weigh 0 through the mask.

    ``chunk_size`` ("auto" / int, full tiles only) accumulates the expected
    log-likelihood over [C]-row slices in a Python loop whose chunks run under
    ``torch.utils.checkpoint``, so the [M, N] whitened
    factor exists one chunk at a time; the Kuu factor pair is computed once,
    outside the loop (``sgpr._resolve_chunk``'s rule)."""
    X, y, m = data["X"], data["y"], data["mask"].to(data["X"].dtype)
    # a trainable prior mean: the expected log-likelihood of the centred obs
    if MF.has_mean(cparams):
        y = y - MF.mean_value(cparams, X)
    N = m.sum(-1)
    if batch_idx is not None:
        idx = torch.as_tensor(batch_idx, device=X.device)
        idx = idx.expand(X.shape[0], -1) if idx.ndim == 1 else idx
        X = torch.gather(X, 1, idx[..., None].expand(-1, -1, X.shape[-1]))
        y, m = torch.gather(y, 1, idx), torch.gather(m, 1, idx)
    lv = cparams["likelihood_variance"]

    C = SG._resolve_chunk(X.shape[1], chunk_size) if batch_idx is None else 0
    if C and X.shape[1] > C:
        L, W = _chol_Kuu(cparams, kernel=kernel, jitter=jitter)
        args = (L, W, cparams["inducing_points"], cparams["lengthscales"], cparams["kernel_variance"],
                cparams["inducing_mean"], cparams["inducing_chol"], lv)
        remat = torch.is_grad_enabled()
        lik_sum = 0.0
        for s in range(0, X.shape[1], C):
            part = args + (X[:, s : s + C], y[:, s : s + C], m[:, s : s + C], kernel, likelihood)
            lik_sum = lik_sum + (checkpoint(_chunk_lik_sum, *part, use_reentrant=False) if remat
                                 else _chunk_lik_sum(*part))
        batch_weight = N  # full tile by construction
    else:
        f_mean, f_var = _whitened_marginals(cparams, X, kernel=kernel, jitter=jitter)
        ve = variational_expectations(likelihood, y, f_mean, f_var, {"variance": lv})
        batch_weight = m.sum(-1)
        lik_sum = torch.sum(ve * m, -1)
    scale = torch.where(batch_weight > 0, N / torch.clamp_min(batch_weight, 1.0), torch.zeros_like(N))
    return scale * lik_sum - kl_whitened(cparams["inducing_mean"], cparams["inducing_chol"])


def predict(cparams: dict, data: dict, Xnew: torch.Tensor, *, kernel: str, jitter: float = DEFAULT_JITTER,
            full_cov: bool = False) -> dict:
    """q(f) marginals at Xnew [B, P, D]: f_mean, f_var, y_var [B, P], and
    with ``full_cov`` f_cov [B, P, P] from the same factor pair and
    whitening product."""
    LW = _chol_Kuu(cparams, kernel=kernel, jitter=jitter)
    f_mean, f_var, A, SA = _marginals_given_L(cparams, LW, Xnew, kernel=kernel, return_factors=True)
    out = {"f_mean": MF.add_mean(cparams, Xnew, f_mean), "f_var": f_var,
           "y_var": f_var + cparams["likelihood_variance"][:, None]}
    if full_cov:
        Kss = K.gram(kernel, Xnew, Xnew, cparams["lengthscales"], cparams["kernel_variance"])
        out["f_cov"] = Kss - torch.matmul(A.transpose(1, 2), A) + torch.matmul(SA.transpose(1, 2), SA)
    return out


def collapsed_q(cparams: dict, data: dict, *, kernel: str, jitter: float = DEFAULT_JITTER, chunk_size="auto",
                accum_precision: str = "highest"):
    """Optimal whitened (q_mu [B, M], q_sqrt [B, M, M]) for a Gaussian
    likelihood at the current hyperparameters: with the SGPR factors
    A = L^-1 Kuf / sigma and B = I + A A^T, m_v = B^-1 A ym / sigma and
    S_v = B^-1 (the collapsed Titsias solution). Both come from
    ``sgpr._common_terms``' pair (LB, WB = LB^-1): m_v = WB^T c and
    B^-1 = WB^T WB. ``accum_precision`` as ``sgpr.elbo``'s."""
    t = SG._common_terms(cparams, data, kernel=kernel, jitter=jitter, chunk_size=chunk_size,
                         accum_precision=accum_precision)
    WBt = t["WB"].transpose(1, 2)
    q_mu = torch.matmul(WBt, t["c"])[..., 0]
    Binv = torch.matmul(WBt, t["WB"])
    # symmetrise before the final Cholesky (f32 roundoff)
    return q_mu, _cholesky(0.5 * (Binv + Binv.transpose(1, 2)))


def natgrad_step(loss_m_S, q_mu: torch.Tensor, q_sqrt: torch.Tensor, gamma: float):
    """One natural-gradient update of (q_mu [B, M], q_sqrt [B, M, M]).

    loss_m_S(m, S) -> [B] loss as a function of the mean and the FULL
    covariance, lanes independent. theta1 = S^-1 m, theta2 = -1/2 S^-1;
    theta_new = theta - gamma dL/d(eta), with dL/d(eta1) = dL/dm - 2 (dL/dS) m
    and dL/d(eta2) = dL/dS."""
    Lq = torch.tril(q_sqrt)
    S = torch.matmul(Lq, Lq.transpose(1, 2))
    m_r, S_r = q_mu.detach().requires_grad_(True), S.detach().requires_grad_(True)
    with torch.enable_grad():
        dm, dS = torch.autograd.grad(loss_m_S(m_r, S_r).sum(), (m_r, S_r))
    dS = 0.5 * (dS + dS.transpose(1, 2))

    I = torch.eye(q_mu.shape[-1], dtype=q_mu.dtype, device=q_mu.device).expand_as(S)
    S_inv = torch.cholesky_solve(I, Lq)
    theta1 = torch.matmul(S_inv, q_mu[..., None])
    theta2 = -0.5 * S_inv
    theta1_new = theta1 - gamma * (dm[..., None] - 2.0 * torch.matmul(dS, q_mu[..., None]))
    theta2_new = theta2 - gamma * dS

    S_new = torch.cholesky_solve(I, _cholesky(-2.0 * theta2_new))
    m_new = torch.matmul(S_new, theta1_new)[..., 0]
    return m_new, _cholesky(0.5 * (S_new + S_new.transpose(1, 2)))


def make_svgp_core(
    kernel: str = "Matern32",
    bijectors: Optional[dict] = None,
    jitter: float = DEFAULT_JITTER,
    num_inducing_points: int = 128,
    likelihood: str = "Gaussian",
    train_inducing_points: bool = False,
    natural_gradients=False,
    gamma: float = 0.1,
    chunk_size="auto",
    q_init="auto",
    solver="auto",
    mean_function=None,
    accum_precision: str = "highest",
):
    """SVGP core for the batched engine, with the JAX package's three solvers
    and their rules (``gpsat_tpu/models/svgp.py::make_svgp_core``):

    - "collapsed" (``solver="auto"`` with the Gaussian likelihood and no
      natural gradients): L-BFGS on the collapsed bound (``sgpr.elbo``) over
      the hyperparameters, q held fixed and set to its closed-form optimum
      by ``finalize_params`` (``collapsed_q``);
    - "lbfgs" (``"auto"`` otherwise): joint L-BFGS over the hyperparameters
      and the whitened (q_mu, q_sqrt) on the full-tile ELBO;
    - "adam": the reference's optimiser (``optimizer="adam"``), with
      ``natural_gradients`` True (one ``natgrad_step`` of size ``gamma`` on
      (q_mu, q_sqrt) before each Adam step) or "exact" (Gaussian only: q
      re-solved in closed form each step).

    ``q_init`` ("auto", "collapsed" or None) warm-starts q at
    ``collapsed_q`` of the initial hyperparameters (``device_init``) on the
    joint L-BFGS solver, and on the Adam solver with the Gaussian likelihood:
    "auto" keeps a lane's q where it is not the default (zero mean, identity
    factor), "collapsed" always replaces it, None keeps the default.

    ``prepare_batch_init`` draws the inducing points per tile as the SGPR
    core does (``sgpr.prepare_inducing_init``); ``chunk_size`` sets the
    large-N accumulation, and ``accum_precision`` the precision of its chunked
    products where the SGPR terms serve (the collapsed bound and
    ``collapsed_q``, as in the JAX package; ``ops/precision``)."""
    from gpsat_tpu_torch.models.functional import ModelCore

    MF.validate(mean_function)
    if bijectors is None:
        bijectors = {n: T.POSITIVE for n in ("lengthscales", "kernel_variance", "likelihood_variance")}
    bijectors = dict(bijectors)
    for n in ("inducing_points", "inducing_mean", "inducing_chol"):
        bijectors[n] = T.IDENTITY
    for n in MF.mean_param_names(mean_function):
        bijectors.setdefault(n, T.IDENTITY)
    mean_names = MF.mean_param_names(mean_function)
    M = int(num_inducing_points)
    kw = dict(kernel=kernel, jitter=jitter, chunk_size=chunk_size)
    # the SGPR terms' keywords: the collapsed bound and collapsed_q
    ckw = dict(kw, accum_precision=PR.accum_precision(accum_precision))

    def forward(uparams):
        return {k: bijectors[k].forward(v) for k, v in uparams.items()}

    def inverse(cparams):
        return {k: bijectors[k].inverse(torch.as_tensor(v)) for k, v in cparams.items()}

    def objective(uparams, data):
        return -elbo(forward(uparams), data, likelihood=likelihood, **kw)

    def predict_fn(cparams, data, Xnew):
        return predict(cparams, data, Xnew, kernel=kernel, jitter=jitter)

    def init_cparams(D: int, dtype=np.float64, overrides: Optional[dict] = None) -> Dict[str, np.ndarray]:
        out = {
            "lengthscales": np.ones((D,), dtype=dtype),
            "kernel_variance": np.asarray(1.0, dtype=dtype),
            "likelihood_variance": np.asarray(1.0, dtype=dtype),
            "inducing_points": np.zeros((M, D), dtype=dtype),
            "inducing_mean": np.zeros((M,), dtype=dtype),
            "inducing_chol": np.eye(M, dtype=dtype),
        }
        out.update(MF.mean_param_defaults(mean_function, D, dtype=dtype))
        for k, v in (overrides or {}).items():
            if k in out:
                v = np.asarray(v, dtype=dtype)
                out[k] = np.broadcast_to(v, out[k].shape).copy() if v.shape != out[k].shape else v
        return out

    def exact_q_update(uparams, data):
        """Closed-form optimal q at the current hyperparameters."""
        q_mu, q_sqrt = collapsed_q(forward(uparams), data, **ckw)
        return {"inducing_mean": q_mu, "inducing_chol": q_sqrt}

    def natgrad_update(uparams, data):
        """(inducing_mean, inducing_chol) after one natural-gradient step on
        the full-tile ELBO (identity bijectors: uparams are cparams there)."""
        c = forward({k: v.detach() for k, v in uparams.items()})

        def loss_m_S(m, S):
            eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
            cc = {**c, "inducing_mean": m, "inducing_chol": _cholesky(S + 1e-12 * eye)}
            return -elbo(cc, data, likelihood=likelihood, **kw)

        m_new, qs_new = natgrad_step(loss_m_S, c["inducing_mean"], c["inducing_chol"], gamma)
        return {"inducing_mean": m_new, "inducing_chol": qs_new}

    def device_init(uparams0, data):
        q = exact_q_update(uparams0, data)
        if q_init == "collapsed":
            return {**uparams0, **q}
        eye = torch.eye(M, dtype=uparams0["inducing_chol"].dtype, device=uparams0["inducing_chol"].device)
        is_default = (uparams0["inducing_mean"] == 0).all(-1) & (uparams0["inducing_chol"] == eye).all(-1).all(-1)
        return {
            **uparams0,
            "inducing_mean": torch.where(is_default[:, None], q["inducing_mean"], uparams0["inducing_mean"]),
            "inducing_chol": torch.where(is_default[:, None, None], q["inducing_chol"], uparams0["inducing_chol"]),
        }

    # the collapsed q start applies to the Adam solver with the Gaussian
    # likelihood only (for the joint L-BFGS solver it is a Gaussian
    # approximation, measured a better start than the identity)
    use_collapsed_init = q_init in ("auto", "collapsed") and likelihood == "Gaussian"
    if natural_gradients == "exact":
        assert likelihood == "Gaussian", "natural_gradients='exact' requires the Gaussian likelihood"
        nat_update = exact_q_update
    elif natural_gradients:
        nat_update = natgrad_update
    else:
        nat_update = None

    # solver='auto' defers to an explicit natural_gradients request (an
    # option of the Adam path only)
    use_collapsed_solver = solver == "collapsed" or (
        solver == "auto" and likelihood == "Gaussian" and not natural_gradients
    )
    if solver == "collapsed":
        assert likelihood == "Gaussian", "solver='collapsed' requires the Gaussian likelihood"
        assert not natural_gradients, (
            "natural_gradients only applies to solver='adam' (the collapsed solver computes the exact q directly)"
        )
    use_lbfgs_solver = solver == "lbfgs" or (solver == "auto" and likelihood != "Gaussian" and not natural_gradients)
    if solver == "lbfgs":
        assert not natural_gradients, (
            "natural_gradients only applies to solver='adam' (the joint L-BFGS solver optimizes q directly)"
        )
    param_names = tuple(PARAM_NAMES) + mean_names
    fixed_Z = () if train_inducing_points else ("inducing_points",)
    prepare_batch_init = functools.partial(SG.prepare_inducing_init, M=M)

    if use_collapsed_solver:
        def collapsed_objective(uparams, data):
            # the collapsed bound over the hyperparameters (+ Z if trained);
            # q is fixed here and set to its optimum afterwards
            return -SG.elbo(forward(uparams), data, **ckw)

        def finalize(cparams, data):
            q_mu, q_sqrt = collapsed_q(cparams, data, **ckw)
            return {**cparams, "inducing_mean": q_mu, "inducing_chol": q_sqrt}

        return ModelCore(
            name=f"SVGP[{kernel},M={M},collapsed]",
            objective=collapsed_objective,
            predict=predict_fn,
            forward=forward,
            inverse=inverse,
            init_cparams=init_cparams,
            param_names=param_names,
            default_fixed_params=("inducing_mean", "inducing_chol") + fixed_Z,
            prepare_batch_init=prepare_batch_init,
            finalize_params=finalize,
            optimizer="lbfgs",
        )
    if use_lbfgs_solver:
        return ModelCore(
            name=f"SVGP[{kernel},M={M},lbfgs]",
            objective=objective,
            predict=predict_fn,
            forward=forward,
            inverse=inverse,
            init_cparams=init_cparams,
            param_names=param_names,
            default_fixed_params=fixed_Z,
            prepare_batch_init=prepare_batch_init,
            device_init=device_init if q_init in ("auto", "collapsed") else None,
            optimizer="lbfgs",
        )
    return ModelCore(
        name=f"SVGP[{kernel},M={M}]",
        objective=objective,
        predict=predict_fn,
        forward=forward,
        inverse=inverse,
        init_cparams=init_cparams,
        param_names=param_names,
        default_fixed_params=fixed_Z,
        prepare_batch_init=prepare_batch_init,
        device_init=device_init if use_collapsed_init else None,
        optimizer="adam",
        natgrad_update=nat_update,
        natgrad_params=("inducing_mean", "inducing_chol") if nat_update is not None else (),
    )


class SVGPModel(GPRModel):
    """SVGP on one expert (the reference's GPflowSVGPModel contract;
    gpsat_tpu/models/svgp.py::SVGPModel): inducing points a random subset
    of the data (``np.random.shuffle``; all the data when
    ``num_inducing_points`` is None or larger, ref: :1058-1066), whitened q
    starting at zero mean and an identity factor, ``minibatch_size``
    points per Adam step (default: all). Three solvers:

    - "adam" (default), the reference's loop: per step one
      ``np.random.default_rng(seed).choice(N, minibatch, replace=False)``
      minibatch, with ``natural_gradients`` one natural-gradient step of
      size ``gamma`` on q before each Adam step (q then kept out of Adam),
      the ELBO checked every ``check_every`` steps and the loop stopped
      after ``persistence`` steps without improvement (or a NaN ELBO);
    - "collapsed" (Gaussian): L-BFGS on the collapsed bound over the
      hyperparameters, then q set to its closed form (``collapsed_q``);
    - "lbfgs" (any likelihood): joint full-batch L-BFGS over the
      hyperparameters and q, q first warm-started at ``collapsed_q`` when
      ``q_init`` says so ("auto": unless q was set; "collapsed": always).

    Every Kuu pair (and B's in the collapsed bound) goes through kernel 1 in
    f32 on the card."""

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
        num_inducing_points: Optional[int] = None,
        minibatch_size: Optional[int] = None,
        kernel_kwargs: Optional[dict] = None,
        noise_variance: Optional[float] = None,
        likelihood: Optional[str] = None,
        likelihood_kwargs: Optional[dict] = None,
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
        self.likelihood = likelihood if likelihood is not None else "Gaussian"
        self.likelihood_kwargs = likelihood_kwargs or {}
        Z = np.array(self.coords, copy=True)
        if num_inducing_points is not None and len(Z) >= num_inducing_points:
            np.random.shuffle(Z)
            Z = Z[:num_inducing_points]
        M = len(Z)
        self._params.update(inducing_points=Z, inducing_mean=np.zeros(M), inducing_chol=np.eye(M))
        for p in ("inducing_points", "inducing_mean", "inducing_chol"):
            self._bijectors[p] = T.IDENTITY
        self.minibatch_size = minibatch_size if minibatch_size is not None else self.coords.shape[0]
        self._last_num_iter = None

    def _elbo(self, cparams: dict, data: dict, batch_idx=None) -> torch.Tensor:
        return elbo(cparams, data, kernel=self.kernel, likelihood=self.likelihood, jitter=self.jitter,
                    batch_idx=batch_idx, chunk_size=self.chunk_size)

    def get_objective_function_value(self) -> float:
        """The ELBO, averaged over at most 100 minibatches (ref: :1101-1107)."""
        data = self._data_dict()
        N = self.coords.shape[0]
        B = min(self.minibatch_size, N)
        rng = np.random.default_rng(0)
        vals = []
        with torch.no_grad():
            for _ in range(min(100, max(N // B, 1))):
                idx = rng.choice(N, size=B, replace=False)
                idx = None if B == N else torch.as_tensor(idx, device=self.device)
                vals.append(float(self._elbo(self._cparams(), data, idx)[0]))
        return float(np.mean(vals))

    def optimise_parameters(
        self,
        train_inducing_points: bool = False,
        natural_gradients: bool = False,
        fixed_params=None,
        gamma: float = 0.1,
        learning_rate: float = 1e-2,
        max_iter: int = 10_000,
        persistence: int = 100,
        check_every: int = 10,
        early_stop: bool = True,
        verbose: bool = False,
        seed: int = 42,
        solver: str = "adam",
        q_init: Optional[str] = "auto",
    ):
        """solver "adam" (the reference's loop), "collapsed" or "lbfgs" (class
        docstring). Returns the L-BFGS solvers' convergence flag; Adam returns
        True when early stopping ended it, False on a NaN ELBO and NaN when it
        ran to ``max_iter``, as the JAX class does."""
        if solver not in ("adam", "collapsed", "lbfgs"):
            raise ValueError(f"solver must be 'adam', 'collapsed' or 'lbfgs', got {solver!r}")
        fixed_params = list(fixed_params or [])
        if not train_inducing_points and "inducing_points" not in fixed_params:
            fixed_params.append("inducing_points")
        if solver == "collapsed":
            return self._optimise_collapsed(fixed_params, max_iter)
        if solver == "lbfgs":
            assert not natural_gradients, (
                "natural_gradients only applies to solver='adam' (the joint L-BFGS solver optimizes q directly)"
            )
            return self._optimise_lbfgs(fixed_params, max_iter, q_init)
        return self._optimise_adam(fixed_params, natural_gradients, gamma, learning_rate, max_iter, persistence,
                                   check_every, early_stop, verbose, seed)

    def _optimise_adam(self, fixed_params, natural_gradients, gamma, learning_rate, max_iter, persistence,
                       check_every, early_stop, verbose, seed):
        from gpsat_tpu_torch.parallel.engine import adam_update

        q_names = ("inducing_mean", "inducing_chol")
        if natural_gradients:
            fixed_params = fixed_params + [p for p in q_names if p not in fixed_params]
        data = self._data_dict()
        bij = self._bijectors
        N = self.coords.shape[0]
        B = min(self.minibatch_size, N)
        u_all = {k: bij[k].inverse(v) for k, v in self._cparams().items()}
        u = {k: v for k, v in u_all.items() if k not in fixed_params}
        u_fixed = {k: v for k, v in u_all.items() if k in fixed_params}
        # the natural-gradient-updated q, kept out of Adam
        q = {k: self._tensor(self._params[k])[None] for k in q_names}

        def loss_fn(u_free, q_, idx):
            c = {k: bij[k].forward(v) for k, v in {**u_free, **u_fixed}.items()}
            if natural_gradients:
                c.update(q_)
            return -self._elbo(c, data, idx)

        def nat_step(idx):
            def loss_m_S(m, S):
                eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
                return loss_fn(u, {"inducing_mean": m, "inducing_chol": _cholesky(S + 1e-12 * eye)}, idx)

            m_new, qs_new = natgrad_step(loss_m_S, q["inducing_mean"], q["inducing_chol"], gamma)
            return {"inducing_mean": m_new.detach(), "inducing_chol": qs_new.detach()}

        mu = {k: torch.zeros_like(v) for k, v in u.items()}
        nu = {k: torch.zeros_like(v) for k, v in u.items()}
        rng = np.random.default_rng(seed)
        max_elbo, max_count, opt_success = -np.inf, 0, np.nan
        step = -1
        for step in range(max_iter):
            idx = rng.choice(N, size=B, replace=False)
            idx = None if B == N else torch.as_tensor(idx, device=self.device)
            if natural_gradients:
                q = nat_step(idx)
            ur = {k: v.detach().requires_grad_(True) for k, v in u.items()}
            with torch.enable_grad():
                loss = loss_fn(ur, q, idx)
                # a free param the loss never reads gets a zero gradient
                grads = torch.autograd.grad(loss.sum(), list(ur.values()), allow_unused=True) if ur else ()
            grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(ur.items(), grads)}
            step_no = torch.full((1,), step + 1.0, dtype=self.dtype, device=self.device)
            u, mu, nu = adam_update(u, grads, mu, nu, step_no, learning_rate)
            if step % check_every == 0:
                cur = -float(loss.detach()[0])
                if np.isnan(cur):
                    print("Optimisation failed...")
                    opt_success = False
                    break
                if verbose:
                    print(f"step: {step},  elbo: {cur:.2f}")
                if cur > max_elbo and early_stop:
                    max_elbo, max_count = cur, 0
                else:
                    max_count += check_every
                    if max_count >= persistence and early_stop:
                        print("objective did not improve stopping")
                        opt_success = True
                        break

        self._last_num_iter = step + 1 if max_iter > 0 else 0
        with torch.no_grad():
            self._params = {k: self._numpy(bij[k].forward(v))[0] for k, v in {**u, **u_fixed}.items()}
        if natural_gradients:
            self._params.update({k: self._numpy(v)[0] for k, v in q.items()})
        self._params["inducing_chol"] = np.tril(self._params["inducing_chol"])
        return opt_success

    def _set_collapsed_q(self):
        with torch.no_grad():
            q_mu, q_sqrt = collapsed_q(self._cparams(), self._data_dict(), kernel=self.kernel, jitter=self.jitter,
                                       chunk_size=self.chunk_size)
        self._params["inducing_mean"] = self._numpy(q_mu)[0]
        self._params["inducing_chol"] = self._numpy(q_sqrt)[0]

    def _optimise_collapsed(self, fixed_params, max_iter):
        assert self.likelihood == "Gaussian", "solver='collapsed' requires the Gaussian likelihood"
        data = self._data_dict()
        kw = dict(kernel=self.kernel, jitter=self.jitter, chunk_size=self.chunk_size)
        ok = self._run_host_lbfgs(lambda c: -SG.elbo(c, data, **kw), fixed_params + ["inducing_mean", "inducing_chol"],
                                  max_iter)
        self._set_collapsed_q()
        return ok

    def _optimise_lbfgs(self, fixed_params, max_iter, q_init="auto"):
        M = np.shape(self._params["inducing_mean"])[0]
        q_is_default = not np.any(self._params["inducing_mean"]) and np.array_equal(
            self._params["inducing_chol"], np.eye(M))
        if q_init == "collapsed" or (q_init == "auto" and q_is_default):
            self._set_collapsed_q()
        data = self._data_dict()
        ok = self._run_host_lbfgs(lambda c: -self._elbo(c, data), fixed_params, max_iter)
        self._params["inducing_chol"] = np.tril(self._params["inducing_chol"])
        return ok

    def _run_host_lbfgs(self, neg_objective, fixed_params, max_iter):
        """The two L-BFGS solvers' shared scaffold (``_minimize``), with the
        iteration count kept as ``_last_num_iter`` too."""
        ok = self._minimize(neg_objective, fixed_params, max_iter)
        self._last_num_iter = self._last_opt_result.num_iter
        return ok

    def predict(self, coords, full_cov: bool = False, apply_scale: bool = True) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            pred = predict(self._cparams(), self._data_dict(), self._prediction_tensor(coords, apply_scale),
                           kernel=self.kernel, jitter=self.jitter, full_cov=full_cov)
        return self._prediction_out(pred, full_cov)

    # --- the variational params (ref: :1259-1310) ---
    def get_inducing_points(self) -> np.ndarray:
        return np.asarray(self._params["inducing_points"])

    def set_inducing_points(self, inducing_points):
        self._params["inducing_points"] = np.asarray(inducing_points, dtype=float)

    def get_inducing_mean(self) -> np.ndarray:
        return np.asarray(self._params["inducing_mean"]).reshape(-1, 1)

    def set_inducing_mean(self, q_mu):
        self._params["inducing_mean"] = np.asarray(q_mu, dtype=float).reshape(-1)

    def get_inducing_chol(self) -> np.ndarray:
        return np.asarray(self._params["inducing_chol"])[None, ...]

    def set_inducing_chol(self, q_sqrt):
        q = np.asarray(q_sqrt, dtype=float)
        if q.ndim == 3:
            q = q[0]
        self._params["inducing_chol"] = np.tril(q)
