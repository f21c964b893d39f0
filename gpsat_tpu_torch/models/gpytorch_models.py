"""Legacy import path (ref: GPSat/models/gpytorch_models.py exports
GPyTorchGPRModel / GPyTorchKISSGPModel / the raw ExactGPR module); the
classes are in torch_gpr.py (gpytorch is not a dependency)."""

import torch

from gpsat_tpu_torch.models.torch_gpr import TorchGPRModel as GPyTorchGPRModel, TorchKISSGPModel as GPyTorchKISSGPModel  # noqa: F401


class ExactGPR:
    """Plain-torch analogue of the reference's gpytorch ExactGP module
    (ref: gpytorch_models.py:17-27): holds training data, a kernel and a
    mean, and maps inputs to the prior (mean, covariance) pair.

    ``kernel`` and ``mean`` are plain callables (``kernel(x1, x2) -> [N1,
    N2] tensor``; ``mean(x) -> [N] tensor``, zeros by default) and
    ``forward`` returns the (mean_x, covar_x) tuple rather than a gpytorch
    MultivariateNormal. ``likelihood`` is stored untouched (the reference
    passes it to the ExactGP base)."""

    def __init__(self, train_x, train_y, kernel, likelihood, mean=None):
        self.train_inputs = (train_x,)
        self.train_targets = train_y
        self.likelihood = likelihood
        self.covar_module = kernel
        self.mean_module = mean if mean is not None else (
            lambda x: torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        )

    def forward(self, x):
        return self.mean_module(x), self.covar_module(x, x)

    def __call__(self, x):
        return self.forward(x)


__all__ = ["GPyTorchGPRModel", "GPyTorchKISSGPModel", "ExactGPR"]
