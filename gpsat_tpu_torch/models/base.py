"""Host-facing base model API, contract-compatible with the reference.

Port of ``gpsat_tpu/models/base.py`` (ref: GPSat/models/base_model.py:17-448):
data ingestion from a DataFrame or raw arrays, coordinate and observation
rescaling, optional 'local' de-meaning, and the reflection-based parameter
API where every name in ``param_names`` has ``get_*`` / ``set_*`` (and
optionally ``set_*_constraints``) methods.

These classes are the single-expert surface. The batched lanes
(``gpsat_tpu_torch.experts``) call the functional cores directly and never
construct one object per expert; the host-serial lane constructs one per
expert for the classes without a batched core.

``TorchCoreModel`` is the shared scaffold of the five classes that evaluate
the port's batched functional cores at B = 1 (GPR, SGPR, SVGP, VFF, ASVGP):
an explicit ``device`` (default: the card, which must exist) and ``dtype``
(default ``torch.float64``, the precision the JAX package's x64 mode gives
these classes; ``torch.float32`` is its f32 mode), parameters kept as
constrained numpy values as the JAX classes keep them, and the batched
``optim/lbfgs.minimize_lbfgs`` run on one lane.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from gpsat_tpu_torch.models import means as MF
from gpsat_tpu_torch.ops import transforms as T

# the tolerances and search of an f32 L-BFGS run (gpsat_tpu/models/gpr.py:
# 373-376): f64-grade thresholds sit below f32 arithmetic noise
F32_OPT_DEFAULTS = dict(tol_grad=1e-3, tol_f=1e-6, linesearch="single_eval")


def _as_scale(s) -> np.ndarray:
    if s is None:
        return np.atleast_2d(1.0)
    if isinstance(s, list):
        return np.array(s, dtype=float)[None, :]
    if isinstance(s, (int, float)):
        return np.array([[float(s)]])
    return np.atleast_2d(np.asarray(s, dtype=float))


class BaseGPRModel(ABC):
    """Abstract base for all local-expert GP models.

    Subclasses implement ``predict``, ``optimise_parameters``,
    ``param_names`` and ``get_objective_function_value`` and provide
    ``get_<p>`` / ``set_<p>`` for each parameter name.
    """

    def __init__(
        self,
        data=None,
        coords_col: Union[str, List[str], None] = None,
        obs_col: Union[str, List[str], None] = None,
        coords: Optional[np.ndarray] = None,
        obs: Optional[np.ndarray] = None,
        coords_scale=None,
        obs_scale=None,
        obs_mean=None,
        verbose: bool = False,
        **kwargs,
    ):
        if data is not None:
            assert coords_col is not None, "data was provided, but coords_col was not"
            assert obs_col is not None, "data was provided, but obs_col was not"
            if isinstance(coords_col, str):
                coords_col = [coords_col]
            if isinstance(obs_col, str):
                obs_col = [obs_col]
            self.obs = data.loc[:, obs_col].values
            self.coords = data.loc[:, coords_col].values
            self.obs_col = obs_col
            self.coords_col = coords_col
        else:
            assert obs is not None and coords is not None, "provide either data or (coords, obs)"
            obs = np.asarray(obs)
            coords = np.asarray(coords)
            if obs.ndim == 1:
                obs = obs[:, None]
            if coords.ndim == 1:
                coords = coords[:, None]
            assert len(obs) == len(coords), "obs and coords lengths don't match"
            self.obs = obs
            self.coords = coords
            self.coords_col = coords_col if coords_col is not None else list(range(coords.shape[1]))
            self.obs_col = obs_col if obs_col is not None else [0]

        assert not np.isnan(self.coords).any(), "nans found in coords"
        assert not np.isnan(self.obs).any(), "nans found in obs"

        # de-meaning: 'local' subtracts the tile's mean (ref: base_model.py:191-209)
        if obs_mean == "local":
            obs_mean = np.mean(self.obs, axis=0, keepdims=True)
        elif obs_mean is None:
            obs_mean = np.zeros((1, 1))
        elif isinstance(obs_mean, list):
            obs_mean = np.array(obs_mean, dtype=float)[None, :]
        elif isinstance(obs_mean, (int, float)):
            obs_mean = np.array([[float(obs_mean)]])
        self.obs_mean = obs_mean

        self.obs_scale = _as_scale(obs_scale)
        self.coords_scale = _as_scale(coords_scale)

        self.coords = self.coords.astype(float) / self.coords_scale
        self.obs = (self.obs.astype(float) - self.obs_mean) / self.obs_scale

        self.gpu_name, self.cpu_name = self._get_device_names()

        # the reflection contract, enforced up front
        for pn in self.param_names:
            assert " " not in pn, f"param_name: '{pn}' contains a space"
            getattr(self, f"set_{pn}")
            getattr(self, f"get_{pn}")

    @staticmethod
    def _get_device_names():
        """(the first CUDA device's name or None, "cpu")."""
        accel = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
        return accel, "cpu"

    # --- abstract contract -------------------------------------------------
    @abstractmethod
    def predict(self, coords: np.ndarray) -> Dict[str, np.ndarray]:
        ...

    @abstractmethod
    def optimise_parameters(self):
        ...

    @property
    @abstractmethod
    def param_names(self) -> List[str]:
        ...

    @abstractmethod
    def get_objective_function_value(self):
        ...

    # --- mean-function params (models/means; shared by every subclass that
    # registers mean_c / mean_A in self._params) ---------------------------
    def get_mean_c(self) -> float:
        return float(self._params["mean_c"])

    def set_mean_c(self, mean_c):
        self._params["mean_c"] = np.asarray(float(np.ravel(mean_c)[0]))

    def get_mean_A(self) -> np.ndarray:
        return np.asarray(self._params["mean_A"])

    def set_mean_A(self, mean_A):
        self._params["mean_A"] = np.asarray(mean_A, dtype=float).reshape(self.coords.shape[1])

    # --- reflection-based parameter API ------------------------------------
    def get_parameters(self, *args, return_dict: bool = True):
        if len(args) == 0:
            args = self.param_names
        for a in args:
            assert a in self.param_names, f"cannot get parameter: {a}; not in {self.param_names}"
        if return_dict:
            return {a: getattr(self, f"get_{a}")() for a in args}
        return [getattr(self, f"get_{a}")() for a in args]

    @staticmethod
    def _attach_full_cov(out: dict, f_cov, likelihood_variance: float) -> dict:
        """The reference's full_cov schema: f*_cov, and y_cov = f*_cov with the
        likelihood variance added to the diagonal
        (ref: GPSat/models/gpflow_models.py:244-260)."""
        f_cov = np.asarray(f_cov)
        out["f*_cov"] = f_cov
        y_cov = f_cov.copy()
        np.fill_diagonal(y_cov, np.diag(y_cov) + float(likelihood_variance))
        out["y_cov"] = y_cov
        return out

    def set_parameters(self, **kwargs):
        for k, v in kwargs.items():
            assert k in self.param_names, f"cannot set parameter: {k}; not in {self.param_names}"
            getattr(self, f"set_{k}")(v)

    def set_parameter_constraints(self, constraints_dict: dict, **kwargs):
        for k, v in constraints_dict.items():
            assert k in self.param_names, f"cannot constrain parameter: {k}; not in {self.param_names}"
            getattr(self, f"set_{k}_constraints")(**v, **kwargs)

    # ----- sigmoid-interval constraints of the models that keep their
    # params in self._params with a bijector per name in self._bijectors
    # (ref: gpflow_models.py:416-494) -----
    def _set_constraint(self, name, low, high, move_within_tol=True, tol=1e-8, scale=False, scale_magnitude=None):
        cur = np.atleast_1d(np.asarray(self._params[name], dtype=float))
        low = np.broadcast_to(np.atleast_1d(np.asarray(low, dtype=float)), cur.shape).copy()
        high = np.broadcast_to(np.atleast_1d(np.asarray(high, dtype=float)), cur.shape).copy()
        assert np.all(low <= high), "all high-constraint values must be >= low"
        if scale:
            mag = self.coords_scale[0, :] if scale_magnitude is None else scale_magnitude
            low, high = low / mag, high / mag
        if move_within_tol:
            cur = T.move_within_tol(cur, low, high, tol=tol)
        if np.asarray(self._params[name]).ndim == 0:
            self._params[name] = np.asarray(cur[0])
            self._bijectors[name] = T.interval(low[0], high[0])
        else:
            self._params[name] = cur
            self._bijectors[name] = T.interval(low, high)

    def set_lengthscales_constraints(self, low, high, **kw):
        self._set_constraint("lengthscales", low, high, **kw)

    def set_kernel_variance_constraints(self, low, high, **kw):
        self._set_constraint("kernel_variance", low, high, **kw)

    def set_likelihood_variance_constraints(self, low, high, **kw):
        self._set_constraint("likelihood_variance", low, high, **kw)

    # ----- prediction coordinates and output, shared by the subclasses -----
    def _prediction_coords(self, coords, apply_scale: bool) -> np.ndarray:
        """[P, D] float coordinates from an array or a DataFrame, divided by
        coords_scale when ``apply_scale``."""
        if hasattr(coords, "loc"):  # a pandas Series or DataFrame
            coords = coords[self.coords_col].values if self.coords_col is not None else coords.values
        coords = np.asarray(coords, dtype=float)
        if coords.ndim == 1:
            coords = coords[None, :]
        return coords / self.coords_scale if apply_scale else coords

    def _add_f_bar(self, out: dict) -> dict:
        f_bar = self.obs_mean[:, 0]
        out["f_bar"] = np.repeat(f_bar, len(out["f*"])) if len(f_bar) != len(out["f*"]) else f_bar
        return out


class lane_param_names:
    """``param_names`` of a class that also runs as a batched lane. Read on
    an instance it is the instance's parameters (``_instance_param_names``),
    as the JAX classes give them; read on the class it is the names the
    class's batched lane stores (the drawn or laid per-tile parameters
    included), which the orchestrator, the smoothing and ``load_params``
    read without building an instance."""

    def __init__(self, lane_names):
        self.lane_names = tuple(lane_names)

    def __get__(self, obj, owner=None):
        return self.lane_names if obj is None else obj._instance_param_names()


class TorchCoreModel(BaseGPRModel):
    """The scaffold of the classes that evaluate the port's functional cores
    on one expert: a batch of B = 1 with an all-ones mask on ``device`` in
    ``dtype``. Subclasses set ``PARAM_NAMES`` (their instance names before
    the mean-function params), ``self._params`` (constrained numpy values)
    and ``self._bijectors``."""

    PARAM_NAMES: tuple = ()

    def _init_device(self, device, dtype):
        from gpsat_tpu_torch.parallel.engine import resolve_device

        self.device = resolve_device(device)
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.dtype = dtype

    def _instance_param_names(self) -> List[str]:
        names = list(self.PARAM_NAMES)
        # (guarded: the base class reads param_names before _params exists)
        for p in ("mean_c", "mean_A"):
            if p in getattr(self, "_params", {}):
                names.append(p)
        return names

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _data_dict(self) -> dict:
        X = self._tensor(self.coords)[None]
        return {"X": X, "y": self._tensor(self.obs[:, 0])[None], "mask": torch.ones_like(X[..., 0])}

    def _cparams(self) -> dict:
        """The constrained params as [1, ...] tensors."""
        return {k: self._tensor(v)[None] for k, v in self._params.items()}

    @staticmethod
    def _numpy(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float64).numpy()

    def _opt_kwargs(self, opt_kwargs: dict) -> dict:
        """``opt_kwargs`` with the f32 defaults filled in for an f32 model."""
        if self.dtype == torch.float32:
            opt_kwargs = {**F32_OPT_DEFAULTS, **opt_kwargs}
        return opt_kwargs

    def _minimize(self, neg_objective, fixed_params, max_iter: int, **opt_kwargs):
        """L-BFGS over the free params: the bijector-inverse split into free
        and fixed, ``minimize_lbfgs`` on one lane, the forward map back into
        ``self._params``. ``neg_objective(cparams) -> [1]`` takes the
        CONSTRAINED [1, ...] params. Keeps the result as ``_last_opt_result``
        (``num_iter``, ``converged``, ``stalled`` of the lane as Python
        values) and returns whether it converged."""
        from gpsat_tpu_torch.optim.lbfgs import minimize_lbfgs

        bij = self._bijectors
        u_all = {k: bij[k].inverse(v) for k, v in self._cparams().items()}
        u_free = {k: v for k, v in u_all.items() if k not in fixed_params}
        u_fixed = {k: v for k, v in u_all.items() if k in fixed_params}

        def objective(u_free_):
            return neg_objective({k: bij[k].forward(v) for k, v in {**u_free_, **u_fixed}.items()})

        res = minimize_lbfgs(objective, u_free, max_iter=max_iter, **self._opt_kwargs(opt_kwargs))
        u_opt = {**res.params, **u_fixed}
        with torch.no_grad():
            self._params = {k: self._numpy(bij[k].forward(v))[0] for k, v in u_opt.items()}
        self._last_opt_result = res._replace(
            params={k: self._numpy(v)[0] for k, v in res.params.items()},
            **{f: bool(getattr(res, f)[0]) for f in ("converged", "failed", "stalled")},
            num_iter=int(res.num_iter[0]),
            final_value=float(res.final_value[0]),
            final_grad_norm=float(res.final_grad_norm[0]),
        )
        return self._last_opt_result.converged

    def _prediction_tensor(self, coords, apply_scale: bool) -> torch.Tensor:
        return self._tensor(self._prediction_coords(coords, apply_scale))[None]

    def _prediction_out(self, pred: dict, full_cov: bool) -> Dict[str, np.ndarray]:
        """The reference's predict dict from a core's [1, P] outputs."""
        out = {
            "f*": self._numpy(pred["f_mean"])[0],
            "f*_var": self._numpy(pred["f_var"])[0],
            "y_var": self._numpy(pred["y_var"])[0],
        }
        if full_cov:
            self._attach_full_cov(out, self._numpy(pred["f_cov"])[0], self._params["likelihood_variance"])
        return self._add_f_bar(out)

    # ----- getters / setters of the GPR trio -----
    def get_lengthscales(self) -> np.ndarray:
        return np.asarray(self._params["lengthscales"])

    def get_kernel_variance(self) -> float:
        return float(self._params["kernel_variance"])

    def get_likelihood_variance(self) -> float:
        return float(self._params["likelihood_variance"])

    def set_lengthscales(self, lengthscales):
        ls = np.asarray(lengthscales, dtype=float)
        if ls.ndim == 0:
            ls = np.full(self.coords.shape[1], float(ls))
        self._params["lengthscales"] = ls

    def set_kernel_variance(self, kernel_variance):
        self._params["kernel_variance"] = np.asarray(np.ravel(kernel_variance)[0], dtype=float)

    def set_likelihood_variance(self, likelihood_variance):
        self._params["likelihood_variance"] = np.asarray(np.ravel(likelihood_variance)[0], dtype=float)

    def _init_gpr_params(self, ls, kv, noise_variance, mean_function, mean_overrides=None):
        """The GPR trio (and the mean-function params) as the JAX classes
        start them, each with its default bijector."""
        D = self.coords.shape[1]
        ls = np.asarray(ls, dtype=float)
        if ls.ndim == 0:
            ls = np.full(D, float(ls))
        self._params = {
            "lengthscales": ls,
            "kernel_variance": np.asarray(float(kv)),
            "likelihood_variance": np.asarray(1.0 if noise_variance is None else float(noise_variance)),
        }
        self._bijectors = {name: T.POSITIVE for name in ("lengthscales", "kernel_variance", "likelihood_variance")}
        for p, dflt in MF.mean_param_defaults(mean_function, D).items():
            override = (mean_overrides or {}).get(p)
            self._params[p] = np.reshape(np.asarray(override, dtype=float), dflt.shape) if override is not None else dflt
            self._bijectors[p] = T.IDENTITY
        self._last_opt_result = None
