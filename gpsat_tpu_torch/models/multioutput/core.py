"""Multi-output GP with a linear observation operator (experimental).

Port of ``gpsat_tpu/models/multioutput/core.py`` (the reference's
GPSat/models/multioutput/ package). Observations are linear combinations
of L latent GPs: y_n = H f(x_n) + eps, eps ~ N(0, R), H: [P, L]. The
latent prior is independent GPs per latent dimension, K[(n,l),(n',l')] =
delta_ll' k_l(x, x'); the LML and the posterior work on the (N P, N P)
flattened covariance.

The latents are the batch dimension of the port's batched functions: one
``ops/kernels.gram`` call builds all L latent Grams, and the SVGP ELBO
takes every latent's Kuu pair from one ``models/svgp._whitened_marginals``
call at B = L. The exact GPR's factor pair of S = H K H^T + R goes through
``ops/linalg.chol_winv_padded``: in f32 on the card that is kernel 1 on S
identity-padded to a multiple of 64; f64 takes the library arm.

The functions take tensors (numpy arrays are converted, f64); the model
classes run on ``device`` (default: the card; ``device="cpu"`` otherwise)
in ``dtype`` (default f64).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from gpsat_tpu_torch.models.base import TorchCoreModel
from gpsat_tpu_torch.ops import kernels as K
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import transforms as T

_LOG_2PI = math.log(2.0 * math.pi)


def _t(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A tensor of ``x``: numpy input as f64 on the CPU, or on ``like``'s
    device in its dtype."""
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, dtype=float))


def latent_gram(X1, X2, lengthscales, variances, kernel: str) -> torch.Tensor:
    """[L] independent latent Grams -> [L, N, M], the latents as the batch
    dimension of one ``gram`` call. lengthscales: [L, D]; variances: [L]."""
    L = lengthscales.shape[0]
    return K.gram(kernel, X1.expand(L, -1, -1), X2.expand(L, -1, -1), lengthscales, variances)


def observed_cov(Kl: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """[L, N, M] latent Grams + H [P, L] -> [N P, M P] observed covariance,
    Cov(y_n^p, y_m^q) = sum_l H[p, l] H[q, l] k_l(x_n, x_m)."""
    HKH = torch.einsum("pl,ql,lnm->pqnm", H, H, Kl)  # [P, P, N, M]
    NP = HKH.shape[2] * HKH.shape[0]
    MQ = HKH.shape[3] * HKH.shape[1]
    return HKH.permute(2, 0, 3, 1).reshape(NP, MQ)  # [N, P, M, Q] -> [(N P), (M Q)]


def _noise_diag(R: torch.Tensor, N: int, P: int) -> torch.Tensor:
    """The [N P] noise diagonal of a scalar or [P] likelihood variance, p
    fastest (``jnp.tile`` of the JAX package)."""
    assert R.ndim <= 1, "likelihood_variance must be scalar or [P]"
    return (R.expand(P) if R.ndim == 0 else R).repeat(N)


def _factor_S(cparams: dict, X, Y, H, kernel: str):
    """(L, W = L^-1) of S = H K H^T + R kron I [N P, N P] through
    ``chol_winv_padded`` (kernel 1 in f32 on the card), differentiable."""
    N, P = Y.shape
    Kl = latent_gram(X, X, cparams["lengthscales"], cparams["kernel_variances"], kernel)
    S = observed_cov(Kl, H)
    S = S + torch.diag(_noise_diag(_t(cparams["likelihood_variance"], S), N, P))
    L, W = LA.chol_winv_padded(S[None])
    return L[0], W[0]


def mo_gpr_lml(cparams: dict, X, Y, H, *, kernel: str = "Matern32") -> torch.Tensor:
    """log N(vec(Y) | 0, H K H^T + R kron I) (ref: gpr.py:41-57)."""
    N, P = Y.shape
    L, W = _factor_S(cparams, X, Y, H, kernel)
    v = torch.matmul(W, Y.reshape(-1, 1))
    return -0.5 * torch.sum(v * v) - torch.sum(torch.log(torch.diagonal(L))) - 0.5 * N * P * _LOG_2PI


def mo_gpr_predict(cparams: dict, X, Y, H, Xnew, *, kernel: str = "Matern32"):
    """Posterior over the LATENT processes f at Xnew: mean [N*, L] and
    marginal variance [N*, L] (ref: gpr.py:59-79, utils.py
    multioutput_conditional)."""
    N, P = Y.shape
    Nn = Xnew.shape[0]
    Lat = cparams["lengthscales"].shape[0]
    _, W = _factor_S(cparams, X, Y, H, kernel)
    Kl_mn = latent_gram(X, Xnew, cparams["lengthscales"], cparams["kernel_variances"], kernel)
    # Cov(y_n^p, f_l(x*)) = H[p, l] k_l(x_n, x*)
    C = torch.einsum("pl,lnm->npml", H, Kl_mn).reshape(N * P, Nn * Lat)
    A = torch.matmul(W, C)
    alpha = torch.matmul(W.T, torch.matmul(W, Y.reshape(-1, 1)))
    mean = torch.matmul(C.T, alpha).reshape(Nn, Lat)
    prior_var = cparams["kernel_variances"][None, :].expand(Nn, Lat)
    return mean, prior_var - torch.sum(A * A, dim=0).reshape(Nn, Lat)


def _latent_marginals(cparams: dict, X, *, kernel: str, jitter: float):
    """Every latent's q(f) marginals [N, L] at X: one ``_whitened_marginals``
    call with the latents as its batch (one factor pair of the L Kuu)."""
    from gpsat_tpu_torch.models.svgp import _whitened_marginals

    Lat = cparams["q_mu"].shape[0]
    c = {
        "inducing_points": cparams["inducing_points"].expand(Lat, -1, -1),
        "lengthscales": cparams["lengthscales"],
        "kernel_variance": cparams["kernel_variances"],
        "inducing_mean": cparams["q_mu"],
        "inducing_chol": cparams["q_sqrt"],
    }
    mu, var = _whitened_marginals(c, X.expand(Lat, -1, -1), kernel=kernel, jitter=jitter)
    return mu.T, var.T


def mo_svgp_elbo(cparams: dict, X, Y, H, *, kernel: str = "Matern32", jitter: float = 1e-6) -> torch.Tensor:
    """Multi-output SVGP ELBO with a linear observation operator
    (ref: multioutput/gpr.py:82-135 MultioutputSVGP + ForwardModelLikelihood).

    L whitened latent SVGPs share inducing locations Z; observations are
    y_n = H f(x_n) + eps with eps ~ N(0, R I_P). E_q[log N(y | H f, R)]
    needs only the latent marginals:
      -P/2 log(2 pi R) - (|y - H mu|^2 + sum_p sum_l H_pl^2 var_l) / (2 R)
    """
    from gpsat_tpu_torch.models.svgp import kl_whitened

    F_mu, F_var = _latent_marginals(cparams, X, kernel=kernel, jitter=jitter)  # [N, L]
    kl = torch.sum(kl_whitened(cparams["q_mu"], cparams["q_sqrt"]))
    R = cparams["likelihood_variance"]
    resid = Y - torch.matmul(F_mu, H.T)  # [N, P]
    var_term = torch.matmul(F_var, (H**2).T)  # [N, P]
    ve = -0.5 * torch.log(2 * math.pi * R) - 0.5 * (resid**2 + var_term) / R
    return torch.sum(ve) - kl


class _TorchModel:
    """Device, dtype and the params dict shared by the two model classes;
    device and dtype follow the host-facing single-expert classes'."""

    _init_device = TorchCoreModel._init_device
    _tensor = TorchCoreModel._tensor
    _numpy = staticmethod(TorchCoreModel._numpy)

    def _c(self) -> dict:
        return {k: self._tensor(v) for k, v in self._params.items()}

    def _data(self):
        return self._tensor(self.coords), self._tensor(self.obs), self._tensor(self.H)


class MultioutputSVGPModel(_TorchModel):
    """Multi-output SVGP with linear observation operator (experimental,
    mirrors the reference's MultioutputSVGP): inducing points a
    ``default_rng(seed)`` draw of the data, Adam as ``optax.adam`` applies
    it, step for step (``parallel/engine.adam_update``)."""

    def __init__(
        self,
        coords: np.ndarray,
        obs: np.ndarray,
        H: np.ndarray,
        num_inducing_points: int = 64,
        kernel: str = "Matern32",
        likelihood_variance: float = 0.1,
        seed: int = 0,
        *,
        device=None,
        dtype=torch.float64,
    ):
        self._init_device(device, dtype)
        self.coords = np.atleast_2d(np.asarray(coords, dtype=float))
        self.obs = np.atleast_2d(np.asarray(obs, dtype=float))
        self.H = np.asarray(H, dtype=float)
        P, L = self.H.shape
        D = self.coords.shape[1]
        self.kernel = kernel
        rng = np.random.default_rng(seed)
        M = min(num_inducing_points, len(self.coords))
        Z = self.coords[rng.choice(len(self.coords), M, replace=False)]
        self._params = {
            "inducing_points": Z,
            "lengthscales": np.ones((L, D)),
            "kernel_variances": np.ones(L),
            "likelihood_variance": np.asarray(float(likelihood_variance)),
            "q_mu": np.zeros((L, M)),
            "q_sqrt": np.stack([np.eye(M)] * L),
        }

    def get_objective_function_value(self) -> float:
        with torch.no_grad():
            return float(mo_svgp_elbo(self._c(), *self._data(), kernel=self.kernel))

    def optimise_parameters(self, max_iter: int = 1000, learning_rate: float = 0.02) -> bool:
        from gpsat_tpu_torch.parallel.engine import adam_update

        X, Y, H = self._data()
        pos = ("lengthscales", "kernel_variances", "likelihood_variance")
        # one Adam lane: every param with a leading dimension of 1
        u = {k: (T.POSITIVE.inverse(v) if k in pos else v)[None] for k, v in self._c().items()}

        def loss(u_):
            c = {k: (T.POSITIVE.forward(v[0]) if k in pos else v[0]) for k, v in u_.items()}
            return -mo_svgp_elbo(c, X, Y, H, kernel=self.kernel)

        mu = {k: torch.zeros_like(v) for k, v in u.items()}
        nu = {k: torch.zeros_like(v) for k, v in u.items()}
        val = None
        for step in range(max_iter):
            ur = {k: v.detach().requires_grad_(True) for k, v in u.items()}
            with torch.enable_grad():
                val = loss(ur)
                grads = torch.autograd.grad(val, list(ur.values()))
            step_no = torch.full((1,), step + 1.0, dtype=self.dtype, device=self.device)
            u, mu, nu = adam_update(u, dict(zip(ur, grads)), mu, nu, step_no, learning_rate)
        with torch.no_grad():
            self._params = {k: self._numpy(T.POSITIVE.forward(v[0]) if k in pos else v[0]) for k, v in u.items()}
        return bool(np.isfinite(float(val.detach()))) if val is not None else True

    def predict(self, coords: np.ndarray) -> Dict[str, np.ndarray]:
        """Latent posterior marginals at coords: mean/var [N*, L]."""
        with torch.no_grad():
            mu, var = _latent_marginals(self._c(), self._tensor(np.atleast_2d(coords)), kernel=self.kernel,
                                        jitter=1e-6)
        return {"f*": self._numpy(mu), "f*_var": self._numpy(var)}


class MultioutputGPRModel(_TorchModel):
    """Host-facing multi-output exact GPR (experimental, mirrors the
    reference's out-of-registry status). The fit is the port's
    ``optim/lbfgs.minimize_lbfgs`` on one lane (zoom in f64; single-eval
    with tol_grad 1e-3, tol_f 1e-6 in f32, as the port's other f32 classes);
    ``_last_opt_result`` keeps its result."""

    def __init__(
        self,
        coords: np.ndarray,
        obs: np.ndarray,
        H: np.ndarray,
        kernel: str = "Matern32",
        lengthscales: Optional[np.ndarray] = None,
        kernel_variances: Optional[np.ndarray] = None,
        likelihood_variance: float = 1.0,
        *,
        device=None,
        dtype=torch.float64,
    ):
        self._init_device(device, dtype)
        self.coords = np.atleast_2d(np.asarray(coords, dtype=float))
        self.obs = np.atleast_2d(np.asarray(obs, dtype=float))
        self.H = np.asarray(H, dtype=float)
        P, L = self.H.shape
        assert self.obs.shape[1] == P, f"obs has {self.obs.shape[1]} outputs but H is [{P}, {L}]"
        D = self.coords.shape[1]
        self.kernel = kernel
        self._params = {
            "lengthscales": np.ones((L, D)) if lengthscales is None else np.asarray(lengthscales, dtype=float),
            "kernel_variances": np.ones(L) if kernel_variances is None else np.asarray(kernel_variances, dtype=float),
            "likelihood_variance": np.asarray(float(likelihood_variance)),
        }

    def get_objective_function_value(self) -> float:
        with torch.no_grad():
            return -float(mo_gpr_lml(self._c(), *self._data(), kernel=self.kernel))

    def optimise_parameters(self, max_iter: int = 500) -> bool:
        from gpsat_tpu_torch.models.base import F32_OPT_DEFAULTS
        from gpsat_tpu_torch.optim.lbfgs import minimize_lbfgs

        X, Y, H = self._data()
        u0 = {k: T.POSITIVE.inverse(v)[None] for k, v in self._c().items()}

        def objective(u):
            c = {k: T.POSITIVE.forward(v[0]) for k, v in u.items()}
            return -mo_gpr_lml(c, X, Y, H, kernel=self.kernel)[None]

        opt = F32_OPT_DEFAULTS if self.dtype == torch.float32 else {}
        res = minimize_lbfgs(objective, u0, max_iter=max_iter, **opt)
        with torch.no_grad():
            self._params = {k: self._numpy(T.POSITIVE.forward(v[0])) for k, v in res.params.items()}
        self._last_opt_result = res
        return bool(res.converged[0])

    def predict(self, coords: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            mean, var = mo_gpr_predict(self._c(), *self._data(), self._tensor(np.atleast_2d(coords)),
                                       kernel=self.kernel)
        return {"f*": self._numpy(mean), "f*_var": self._numpy(var)}


# --------------------------------------------------------------------------
# Forward models + model-based likelihoods
# (ref: multioutput/utils.py:9-65, multioutput/likelihoods.py:14-216)
# --------------------------------------------------------------------------


def multivariate_gaussian_log_density(x, mu, cov) -> torch.Tensor:
    """log N(x | mu, cov), batched over leading dims
    (ref: multioutput/utils.py multivariate_gaussian_log_density)."""
    mu = _t(mu)
    x, cov = _t(x, mu), _t(cov, mu)
    P = mu.shape[-1]
    diff = (mu - x)[..., :, None]
    sol = torch.linalg.solve(cov.expand(mu.shape + (P,)), diff)
    _, logdet = torch.linalg.slogdet(cov)
    quad = torch.matmul(diff.transpose(-1, -2), sol)[..., 0, 0]
    return -(P / 2) * _LOG_2PI - 0.5 * logdet - 0.5 * quad


def add_likelihood_noise_cov(K, R) -> torch.Tensor:
    """K: [..., N, N, P, P]; adds block-diagonal R at n == n'
    (ref: multioutput/utils.py add_likelihood_noise_cov)."""
    K = _t(K)
    N = K.shape[-3]
    eye = torch.eye(N, dtype=K.dtype, device=K.device)[:, :, None, None]
    return K + eye * _t(R, K)


def multioutput_conditional(Kmn, Kmm, Knn, f, H, R, *, full_cov: bool = False):
    """Posterior over L latent processes at N points given M observed
    P-vectors f (ref: multioutput/utils.py multioutput_conditional).

    Kmn: [M, L, N, L]; Kmm: [M, L, M, L]; Knn: [N, L, N, L] (full_cov) or
    [N, L, L]; f: [M, P]; H: [P, L]; R: [P, P].
    Returns (mean [N, L], var [N, L, N, L] | [N, L, L]): the 4-d tensors
    collapsed to dense matrices with the block operator kron(I_M, H), one
    Cholesky of (M P, M P).
    """
    Kmn = _t(Kmn)
    Kmm, Knn, f, H, R = (_t(a, Kmn) for a in (Kmm, Knn, f, H, R))
    M, L, N, _ = Kmn.shape
    P = H.shape[0]
    eye_m = torch.eye(M, dtype=Kmn.dtype, device=Kmn.device)
    Hb = torch.kron(eye_m, H)  # [M P, M L]
    ks = Hb @ Kmm.reshape(M * L, M * L) @ Hb.T + torch.kron(eye_m, R)
    Lm = torch.linalg.cholesky(ks)
    A = torch.linalg.solve_triangular(Lm, Hb @ Kmn.reshape(M * L, N * L), upper=False)  # [M P, N L]
    if full_cov:
        fvar = (Knn.reshape(N * L, N * L) - A.T @ A).reshape(N, L, N, L)
    else:
        AtA = torch.einsum("ka,kb->ab", A, A).reshape(N, L, N, L)
        fvar = Knn - torch.diagonal(AtA, dim1=0, dim2=2).permute(2, 0, 1)
    A2 = torch.linalg.solve_triangular(Lm.T, A, upper=True)
    fmean = (A2.T @ f.reshape(M * P, 1)).reshape(N, L)
    return fmean, fvar


class ForwardModel:
    """Measurement operator h(x): latent F -> observation space
    (ref: multioutput/utils.py ForwardModel)."""

    def __init__(self, input_dim: int, latent_dim: int, observation_dim: int, *args, **kwargs):
        self.input_dim = input_dim
        self.latent_dim = latent_dim
        self.observation_dim = observation_dim

    def _forward(self, X, F):
        raise NotImplementedError

    def __call__(self, X, F):
        return self._forward(X, F)


class LinearForwardModel(ForwardModel):
    """y = H f, H: [P, L] (ref: multioutput/utils.py LinearForwardModel)."""

    def __init__(self, input_dim: int, latent_dim: int, observation_dim: int, H):
        super().__init__(input_dim, latent_dim, observation_dim)
        H = _t(H)
        assert tuple(H.shape) == (observation_dim, latent_dim), (
            "Tensor H in forward model must be of shape (obs_dim, latent_dim)"
        )
        self.tensor = H

    def _forward(self, X, F):
        F = _t(F)
        return torch.einsum("pl,...l->...p", _t(self.tensor, F), F)

    def propagate_mean(self, Fmu):
        return self._forward(None, Fmu)

    def propagate_cov(self, Fcov):
        Fcov = _t(Fcov)
        H = _t(self.tensor, Fcov)
        return H @ Fcov @ H.T


class ForwardModelLikelihood:
    """y = h(x) + eps, eps ~ N(0, R) (ref: multioutput/likelihoods.py:14-37)."""

    def __init__(self, variance, *args, **kwargs):
        self.h = self.get_model(*args, **kwargs)
        assert isinstance(self.h, ForwardModel)
        P = self.h.observation_dim
        if isinstance(variance, (int, float)):
            variance = variance * np.eye(P)
        variance = _t(variance)
        assert tuple(variance.shape) == (P, P)
        self.variance = variance
        self.input_dim = self.h.input_dim
        self.latent_dim = self.h.latent_dim
        self.observation_dim = self.h.observation_dim

    def get_model(self, *args, **kwargs) -> ForwardModel:
        raise NotImplementedError


class LinearModelLikelihood(ForwardModelLikelihood):
    """y = Hx + noise (ref: multioutput/likelihoods.py:40-146). Closed-form
    moments and expectations for the linear-Gaussian case."""

    def __init__(self, input_dim: int, variance, forward_model):
        super().__init__(variance, input_dim, forward_model)
        self.H = self.h.tensor

    def get_model(self, input_dim, forward_model):
        if isinstance(forward_model, LinearForwardModel):
            return forward_model
        H = _t(forward_model)
        observation_dim, latent_dim = H.shape
        return LinearForwardModel(input_dim, latent_dim, observation_dim, H)

    def variance_at(self, X):
        X = _t(X)
        P = self.variance.shape[0]
        return _t(self.variance, X).expand(X.shape[:-1] + (P, P))

    def log_prob(self, X, F, Y):
        return multivariate_gaussian_log_density(Y, self.h(X, F), self.variance)

    def conditional_mean(self, X, F):
        return self.h(X, F)

    def conditional_variance(self, X, F):
        F = _t(F)
        return torch.diag(_t(self.variance, F)).expand(F.shape[:-1] + (self.observation_dim,))

    def predict_mean_and_var(self, X, Fmu, Fcov):
        cov = self.h.propagate_cov(Fcov)
        return self.h.propagate_mean(Fmu), cov + _t(self.variance, cov)

    def predict_log_density(self, X, Fmu, Fcov, Y):
        cov = self.h.propagate_cov(Fcov)
        return multivariate_gaussian_log_density(Y, self.h.propagate_mean(Fmu), cov + _t(self.variance, cov))

    def variational_expectations(self, X, Fmu, Fcov, Y):
        """E_q[log p(y | f)] for q = N(Fmu, Fcov) (ref: likelihoods.py:121-141):
        the Gaussian log-density at the propagated mean minus half the
        propagated-covariance trace term."""
        HFmu = self.h.propagate_mean(Fmu)
        HFcovHt = self.h.propagate_cov(Fcov)
        R = _t(self.variance, HFcovHt)
        base = multivariate_gaussian_log_density(Y, HFmu, R)
        tr = torch.diagonal(torch.linalg.solve(R.expand(HFcovHt.shape), HFcovHt), dim1=-2, dim2=-1).sum(-1)
        return base - 0.5 * tr


class NonlinearModelLikelihood(ForwardModelLikelihood):
    """y = h(x) + noise for nonlinear h; variational expectations by Monte
    Carlo over q(f) (ref: multioutput/likelihoods.py:149-216). The normal
    draws come from a ``torch.Generator`` seeded by ``seed`` on each call,
    so a call is deterministic (the JAX package keeps one PRNG key)."""

    def __init__(self, forward_model: ForwardModel, variance, num_samples: int = 100, seed: int = 0):
        super().__init__(variance, forward_model)
        self.num_monte_carlo_points = num_samples
        self.seed = seed

    def get_model(self, forward_model):
        return forward_model

    def log_prob(self, X, F, Y):
        return multivariate_gaussian_log_density(Y, self.h(X, F), self.variance)

    def variational_expectations(self, X, Fmu, Fcov, Y):
        Fmu = _t(Fmu)
        Fcov, Y = _t(Fcov, Fmu), _t(Y, Fmu)
        S = self.num_monte_carlo_points
        N, D = Fmu.shape[-2], Fmu.shape[-1]
        gen = torch.Generator(device=Fmu.device).manual_seed(self.seed)
        eps = torch.randn((S, N, D), generator=gen, dtype=Fmu.dtype, device=Fmu.device)
        Lc = torch.linalg.cholesky(Fcov)
        samples = Fmu[None] + torch.einsum("nde,sne->snd", Lc, eps)
        lp = multivariate_gaussian_log_density(Y.expand((S,) + Y.shape), self.h(X, samples), self.variance)
        return torch.mean(lp, dim=0)


# reference class-name aliases (ref: multioutput/gpr.py:14,82)
MultioutputGPR = MultioutputGPRModel
MultioutputSVGP = MultioutputSVGPModel
