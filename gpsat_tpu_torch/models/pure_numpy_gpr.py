"""Pure numpy/scipy exact GPR with analytic gradients — the in-repo oracle.

Behavioral port of the reference's PurePythonGPR
(ref: GPSat/models/pure_python_gpr.py — 'the numerical ground truth'):
Matern-3/2 Gram construction with analytic hyperparameter gradients
(:378-405), negative log marginal likelihood by Cholesky (Rasmussen &
Williams Algo 2.1, :439-506), Nystrom approximation + Woodbury (:408-435),
posterior prediction (:509-553), and scipy L-BFGS-B optimization in
transformed (softplus/exp) variable space (:269-342).

The port's own copy of ``gpsat_tpu/models/pure_numpy_gpr.py``: no torch, the
independent cross-check of the host-serial lane (as the reference
cross-checks PurePythonGPR against GPflow, :556-672).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.optimize
from scipy.spatial.distance import cdist, pdist, squareform


def sgp_kernel(x, xs=None, grad: bool = False, ell=1.0, sigma: float = 1.0):
    """Matern-3/2 Gram (optionally with per-lengthscale gradients)."""
    ell = np.atleast_1d(np.asarray(ell, dtype=float))
    if xs is None:
        Q = squareform(pdist(np.sqrt(3.0) * x / ell, "euclidean"))
        k = (1 + Q) * np.exp(-Q)
        if grad:
            dk = np.zeros((len(ell),) + k.shape)
            for t in range(len(ell)):
                q = squareform(pdist(np.sqrt(3.0) * np.atleast_2d(x[:, t] / ell[t]).T, "euclidean"))
                dk[t] = q * q * np.exp(-Q)
            return sigma * k, sigma * dk
        return sigma * k
    Q = cdist(np.sqrt(3.0) * x / ell, np.sqrt(3.0) * xs / ell, "euclidean")
    k = (1 + Q) * np.exp(-Q)
    return sigma * k


def nystroem(x, y, M, ell, sf2, sn2, seed: int = 20, opt: bool = False):
    """Rank-M Nystrom approximation of K^-1 via Woodbury."""
    rng = np.random.RandomState(seed)
    n = len(y)
    sel = sorted(rng.choice(range(n), M, replace=False))
    Kmm = sgp_kernel(x[sel, :], ell=ell, sigma=sf2)
    Knm = sgp_kernel(x, xs=x[sel, :], ell=ell, sigma=sf2)
    Vi = np.eye(n) / sn2
    s, u = np.linalg.eigh(Kmm)
    s[s <= 0] = 1e-12
    s_t = n * s / M
    u_t = np.sqrt(M / n) * (Knm @ u) / s
    L = np.linalg.cholesky(np.diag(1 / s_t) + u_t.T @ Vi @ u_t)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, u_t.T @ Vi))
    Ki = Vi - Vi @ u_t @ alpha
    if opt:
        L_t = np.sqrt(s_t) * u_t
        det = np.linalg.slogdet(np.eye(M) * sn2 + L_t.T @ L_t)
        return Ki, np.atleast_2d(Ki @ y).T, (det[0] * det[1]) / 2
    return Ki, np.atleast_2d(Ki @ y).T


def neg_lml(hypers, x, y, approx: bool = False, M=None, grad: bool = True):
    """Negative LML (+ analytic gradients) at raw hyperparameters
    [lengthscales..., kernel_var, noise_var]."""
    ell = hypers[:-2]
    sf2 = hypers[-2]
    sn2 = hypers[-1]
    n = len(y)
    Kx, dK = sgp_kernel(x, grad=True, ell=ell, sigma=sf2)
    try:
        if approx:
            Ki, A, det = nystroem(x, y, M=M, ell=ell, sf2=sf2, sn2=sn2, opt=True)
            nlZ = float(y.T @ A) / 2 + det + n * np.log(2 * np.pi) / 2
            Q = Ki - A @ A.T
        else:
            L = np.linalg.cholesky(Kx + np.eye(n) * sn2)
            A = np.atleast_2d(np.linalg.solve(L.T, np.linalg.solve(L, y))).T
            nlZ = float((y @ A).item()) / 2 + np.log(L.diagonal()).sum() + n * np.log(2 * np.pi) / 2
            Q = np.linalg.solve(L.T, np.linalg.solve(L, np.eye(n))) - A @ A.T
        if grad:
            # true raw-space gradients (the reference's formulas are
            # log-space and unused — its optimise() defaults jac=False,
            # ref: pure_python_gpr.py:268,439-506): dnlZ = 0.5 tr(Q dK/dθ)
            # with sgp_kernel's dk being ell * dK/d(ell)
            dnlZ = np.zeros(len(hypers))
            for t in range(len(hypers)):
                if t < len(hypers) - 2:
                    dnlZ[t] = (Q * dK[t]).sum() / 2 / ell[t]
                elif t == len(hypers) - 2:
                    dnlZ[t] = (Q * Kx).sum() / 2 / sf2
                else:
                    dnlZ[t] = np.trace(Q) / 2
            return nlZ, dnlZ
        return nlZ
    except np.linalg.LinAlgError:
        if grad:
            return np.inf, np.ones(len(hypers)) * np.inf
        return np.inf


def gpr_predict(x, y, xs, ell, sf2, sn2, mean=0.0, approx: bool = False, M=None):
    """Posterior mean + predictive std at xs (Rasmussen Algo 2.1)."""
    n = len(y)
    Kxsx = sgp_kernel(x, xs=xs, ell=ell, sigma=sf2)
    Kxs = sgp_kernel(xs, ell=ell, sigma=sf2)
    if approx:
        if M is None:
            M = int(n / 5)
        Ki, A = nystroem(x, y, M=M, ell=ell, sf2=sf2, sn2=sn2)
        err = Kxsx.T @ Ki @ Kxsx
        A = Ki @ y
    else:
        Kx = sgp_kernel(x, ell=ell, sigma=sf2) + np.eye(n) * sn2
        L = np.linalg.cholesky(Kx)
        A = np.linalg.solve(L.T, np.linalg.solve(L, y))
        v = np.linalg.solve(L, Kxsx)
        err = v.T @ v
    fs = mean + Kxsx.T @ A
    sfs = np.sqrt((Kxs - err).diagonal())
    return fs, sfs


class PureNumpyGPR:
    """Self-contained Matern-3/2 exact GPR; scipy L-BFGS-B in log space."""

    def __init__(
        self,
        coords: np.ndarray,
        obs: np.ndarray,
        length_scales=1.0,
        kernel_var: float = 1.0,
        likeli_var: float = 1.0,
        mean: float = 0.0,
    ):
        self.x = np.atleast_2d(np.asarray(coords, dtype=float))
        y = np.asarray(obs, dtype=float)
        self.y = y[:, None] if y.ndim == 1 else y
        D = self.x.shape[1]
        ls = np.atleast_1d(np.asarray(length_scales, dtype=float))
        self.length_scales = np.full(D, ls[0]) if len(ls) == 1 else ls
        self.kernel_var = float(kernel_var)
        self.likeli_var = float(likeli_var)
        self.mean = float(mean)
        # optional per-parameter [low, high] box constraints, applied as
        # log-space bounds in the L-BFGS-B run (ref: pure_python_gpr.py
        # :60-235 transform bookkeeping / set_*_constraints)
        self._bounds = {}

    @property
    def param_names(self):
        return ["lengthscales", "kernel_variance", "likelihood_variance"]

    def get_objective_function_value(self) -> float:
        h = np.concatenate([self.length_scales, [self.kernel_var, self.likeli_var]])
        return float(neg_lml(h, self.x, self.y[:, 0], grad=False))

    def get_loglikelihood(self) -> float:
        """Log marginal likelihood at the current hyperparameters
        (ref: pure_python_gpr.py:344-358)."""
        return -self.get_objective_function_value()

    def optimise(self, opt_method: str = "L-BFGS-B", jac: bool = False) -> bool:
        """Reference-named optimizer entry (ref: pure_python_gpr.py:303-342;
        there jac defaults False = finite differences — honored here)."""
        return self.optimise_parameters(opt_method=opt_method, jac=jac)

    def _log_bounds(self):
        """Per-variable (low, high) log-space bounds for L-BFGS-B, or None."""
        if not self._bounds:
            return None
        D = len(self.length_scales)
        lo = np.full(D + 2, -np.inf)
        hi = np.full(D + 2, np.inf)
        spans = {"lengthscales": slice(0, D), "kernel_variance": slice(D, D + 1),
                 "likelihood_variance": slice(D + 1, D + 2)}
        for name, (low, high) in self._bounds.items():
            s = spans[name]
            lo[s] = np.broadcast_to(low, (s.stop - s.start,))
            hi[s] = np.broadcast_to(high, (s.stop - s.start,))
        with np.errstate(divide="ignore"):
            return list(zip(np.log(np.maximum(lo, 1e-300)), np.log(hi)))

    def _set_constraint(self, name, low, high, move_within_tol=True, tol=1e-2, scale=False, scale_magnitude=None):
        low = np.asarray(low, dtype=float)
        high = np.asarray(high, dtype=float)
        assert np.all(low <= high), f"constraint low > high for {name}"
        if scale and name == "lengthscales":
            s = scale_magnitude if scale_magnitude is not None else 1.0
            low, high = low / s, high / s
        self._bounds[name] = (low, high)
        cur = np.asarray(self.get_parameters()[name], dtype=float)
        if move_within_tol:
            cur = np.clip(cur, low + tol, high - tol)
        else:
            cur = np.clip(cur, low, high)
        getattr(self, f"set_{name}")(cur)

    def set_lengthscales_constraints(self, low, high, **kwargs):
        self._set_constraint("lengthscales", low, high, **kwargs)

    def set_kernel_variance_constraints(self, low, high, **kwargs):
        self._set_constraint("kernel_variance", low, high, **kwargs)

    def set_likelihood_variance_constraints(self, low, high, **kwargs):
        self._set_constraint("likelihood_variance", low, high, **kwargs)

    def set_parameter_constraints(self, constraints_dict: dict, **kwargs):
        for k, v in constraints_dict.items():
            assert k in self.param_names, f"cannot constrain parameter: {k}"
            getattr(self, f"set_{k}_constraints")(**v, **kwargs)

    def get_parameters(self, *args, return_dict: bool = True):
        args = args or self.param_names
        if return_dict:
            return {a: getattr(self, f"get_{a}")() for a in args}
        return [getattr(self, f"get_{a}")() for a in args]

    def set_parameters(self, **kwargs):
        for k, v in kwargs.items():
            assert k in self.param_names, f"cannot set parameter: {k}"
            getattr(self, f"set_{k}")(v)

    def optimise_parameters(self, opt_method: str = "L-BFGS-B", jac: bool = True) -> bool:
        """Optimize in log space (strictly-positive reparameterization);
        box constraints from set_*_constraints become log-space bounds."""
        x0 = np.log(np.concatenate([self.length_scales, [self.kernel_var, self.likeli_var]]))

        def obj(v):
            h = np.exp(v)
            if jac:
                nlZ, d = neg_lml(h, self.x, self.y[:, 0], grad=True)
                return nlZ, d * h  # chain rule through exp
            return neg_lml(h, self.x, self.y[:, 0], grad=False)

        res = scipy.optimize.minimize(obj, x0=x0, method=opt_method, jac=jac,
                                      bounds=self._log_bounds())
        self._last_num_iter = int(res.get("nit", 0))
        h = np.exp(res.x)
        self.length_scales = h[:-2]
        self.kernel_var = float(h[-2])
        self.likeli_var = float(h[-1])
        return bool(res["success"])

    def predict(self, coords, approx: bool = False, M=None) -> Dict[str, np.ndarray]:
        xs = np.atleast_2d(np.asarray(coords, dtype=float))
        fs, sfs = gpr_predict(
            self.x, self.y[:, 0], xs, self.length_scales, self.kernel_var, self.likeli_var,
            mean=self.mean, approx=approx, M=M,
        )
        return {"f*": np.ravel(fs), "f*_var": sfs**2, "y_var": sfs**2 + self.likeli_var}

    # reflection API parity
    def get_lengthscales(self):
        return self.length_scales

    def get_kernel_variance(self):
        return self.kernel_var

    def get_likelihood_variance(self):
        return self.likeli_var

    def set_lengthscales(self, v):
        self.length_scales = np.atleast_1d(np.asarray(v, dtype=float))

    def set_kernel_variance(self, v):
        self.kernel_var = float(np.ravel(v)[0])

    def set_likelihood_variance(self, v):
        self.likeli_var = float(np.ravel(v)[0])


# --------------------------------------------------------------------------
# reference-named aliases (migration surface; same signatures/semantics as
# GPSat/models/pure_python_gpr.py:378-553)
# --------------------------------------------------------------------------

SGPkernel = sgp_kernel
Nystroem = nystroem


def SMLII_mod(hypers, x, y, approx=False, M=None, grad=True, use_log=True):
    """Negative LML objective (ref: pure_python_gpr.py:439-506). The
    reference's ``use_log`` flag is dead code there (hypers are consumed
    raw); accepted and ignored for signature parity."""
    del use_log
    return neg_lml(hypers, x, y, approx=approx, M=M, grad=grad)


def GPR(x, y, xs, ell, sf2, sn2, mean, approx=False, M=None, returnprior=False):
    """Posterior mean + predictive std at xs (ref: pure_python_gpr.py:509-553).

    Returns (fs, sfs) or, with ``returnprior``, (fs, sfs, prior_std)."""
    fs, sfs = gpr_predict(x, y, xs, ell=ell, sf2=sf2, sn2=sn2, mean=mean,
                          approx=approx, M=M)
    if returnprior:
        prior_sd = np.sqrt(sgp_kernel(xs, ell=ell, sigma=sf2).diagonal())
        return fs, sfs, prior_sd
    return fs, sfs
