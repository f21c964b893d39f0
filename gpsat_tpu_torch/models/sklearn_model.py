"""sklearn-backed exact GPR — the CPU comparison model of the host-serial lane.

The port's own copy of ``gpsat_tpu/models/sklearn_model.py``, a behavioural
port of the reference's sklearnGPRModel
(ref: GPSat/models/sklearn_models.py:16-357): kernel composed as
``Matern(length_scale) * ConstantKernel(sqrt(kernel_variance))`` (+ an
additive ConstantKernel mean), fixed likelihood variance via ``alpha``
(not trainable), ``fit`` with n_restarts_optimizer=2 as the optimizer,
log-space hyperparameter bounds for constraints, and a 'fake fit'
(optimizer=None) so predict/objective work before training.

sklearn is imported when a model is built, never when the module is, so
the package imports where sklearn is not installed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from gpsat_tpu_torch.models.base import BaseGPRModel


class SklearnGPRModel(BaseGPRModel):
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
        kernel_kwargs: Optional[dict] = None,
        mean_value: Optional[float] = None,
        kernel_variance: Optional[float] = 1.0,
        likelihood_variance: Optional[float] = None,
        param_bounds: Optional[dict] = None,
        **kwargs,
    ):
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
        import sklearn.gaussian_process
        from sklearn.gaussian_process import GaussianProcessRegressor
        from sklearn.gaussian_process.kernels import ConstantKernel

        assert kernel is not None, "kernel was not provided"
        if isinstance(kernel, str):
            kernel_kwargs = dict(kernel_kwargs or {})
            kernel_cls = getattr(sklearn.gaussian_process.kernels, kernel)
            import inspect

            if "length_scale" in inspect.signature(kernel_cls).parameters and "length_scale" not in kernel_kwargs:
                kernel_kwargs["length_scale"] = np.ones(self.coords.shape[1])
            kernel = kernel_cls(**kernel_kwargs)

        if mean_value is not None:
            kernel = kernel + ConstantKernel(mean_value)
        if kernel_variance is not None:
            kernel = kernel * ConstantKernel(np.sqrt(kernel_variance))
        if param_bounds is not None:
            for hyperparameter in kernel.hyperparameters:
                hyperparameter.bounds = param_bounds[hyperparameter.name]

        self.model = GaussianProcessRegressor(
            kernel=kernel,
            alpha=1.0 if likelihood_variance is None else likelihood_variance,
            n_restarts_optimizer=2,
        )

    @property
    def param_names(self) -> List[str]:
        return ["lengthscales", "kernel_variance", "likelihood_variance"]

    def _fake_fit(self):
        optimizer = self.model.optimizer
        self.model.optimizer = None
        self.model.fit(X=self.coords, y=self.obs)
        self.model.optimizer = optimizer

    def optimise_parameters(self, opt=None, **kwargs) -> bool:
        self.model.optimizer = "fmin_l_bfgs_b" if opt is None else opt
        try:
            self.model = self.model.fit(self.coords, self.obs)
            return True
        except Exception:
            print("optimization failed!")
            return False

    def get_objective_function_value(self):
        try:
            return self.model.log_marginal_likelihood()
        except AttributeError:
            self._fake_fit()
            return -self.model.log_marginal_likelihood()

    def predict(self, coords, full_cov: bool = False, apply_scale: bool = True) -> Dict[str, np.ndarray]:
        coords = self._prediction_coords(coords, apply_scale)
        try:
            _ = self.model.kernel_
        except AttributeError:
            self._fake_fit()
        if full_cov:
            f_mean, f_cov = self.model.predict(X=coords, return_cov=True)
            out = {
                "f*": np.atleast_1d(np.squeeze(f_mean)),
                "f*_var": np.diag(f_cov),
                "f*_cov": f_cov,
            }
        else:
            f_mean, f_std = self.model.predict(X=coords, return_std=True)
            out = {"f*": np.atleast_1d(np.squeeze(f_mean)), "f*_var": np.atleast_1d(f_std**2)}
        return self._add_f_bar(out)

    # --- getters/setters ---
    def _extract_k1k2(self):
        import sklearn.gaussian_process

        try:
            kernel = self.model.kernel_
        except AttributeError:
            kernel = self.model.kernel
        if self.model.kernel.__class__ == sklearn.gaussian_process.kernels.Sum:
            k = kernel.k1
            return k.k1, k.k2
        if self.model.kernel.__class__ == sklearn.gaussian_process.kernels.Product:
            return kernel.k1, kernel.k2
        return kernel, None

    def get_lengthscales(self):
        k1, _ = self._extract_k1k2()
        return np.atleast_1d(k1.length_scale)

    def get_kernel_variance(self):
        _, k2 = self._extract_k1k2()
        return 1.0 if k2 is None else float(k2.constant_value) ** 2

    def get_likelihood_variance(self):
        return self.model.alpha

    def set_lengthscales(self, lengthscales):
        k1, _ = self._extract_k1k2()
        k1.length_scale = lengthscales

    def set_kernel_variance(self, kernel_variance):
        _, k2 = self._extract_k1k2()
        if k2 is not None:
            k2.constant_value = np.sqrt(kernel_variance)

    def set_likelihood_variance(self, likelihood_variance):
        self.model.alpha = likelihood_variance

    # --- constraints (log-space bounds; ref: :281-339) ---
    def _preprocess_constraint(self, param_name, low, high, move_within_tol=True, tol=1e-8, scale=False):
        param = np.atleast_1d(np.array(self.get_parameters()[param_name], dtype=float))
        low = np.atleast_1d(np.asarray(low, dtype=float))
        high = np.atleast_1d(np.asarray(high, dtype=float))
        assert len(param) == len(low), f"low constraint length mismatch for {param_name}"
        assert len(param) == len(high), f"high constraint length mismatch for {param_name}"
        assert np.all(low <= high), "all high-constraint values must be >= low"
        if scale:
            low = low / self.coords_scale[0, :]
            high = high / self.coords_scale[0, :]
        if move_within_tol:
            param = np.where(param > high - tol, high - tol, param)
            param = np.where(param < low + tol, low + tol, param)
        return low, high

    def set_lengthscales_constraints(self, low, high, move_within_tol=True, tol=1e-8, scale=False):
        low, high = self._preprocess_constraint("lengthscales", low, high, move_within_tol, tol, scale)
        k1, _ = self._extract_k1k2()
        k1.length_scale_bounds = [(lo, hi) for lo, hi in zip(low, high)]

    def set_kernel_variance_constraints(self, low, high, move_within_tol=True, tol=1e-8, scale=False):
        low, high = self._preprocess_constraint("kernel_variance", low, high, move_within_tol, tol, scale)
        _, k2 = self._extract_k1k2()
        if k2 is not None:
            k2.constant_value_bounds = (low[0], high[0])

    def set_likelihood_variance_constraints(self, *args, **kwargs):
        # alpha is fixed in sklearn GPR — not trainable, nothing to constrain
        pass
