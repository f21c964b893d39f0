"""Legacy import path (ref: GPSat/models/multioutput/utils.py exports
the forward models and multioutput conditional helpers)."""

from gpsat_tpu_torch.models.multioutput.core import (  # noqa: F401
    ForwardModel,
    LinearForwardModel,
    add_likelihood_noise_cov,
    multioutput_conditional,
    multivariate_gaussian_log_density,
)

__all__ = [
    "ForwardModel",
    "LinearForwardModel",
    "add_likelihood_noise_cov",
    "multioutput_conditional",
    "multivariate_gaussian_log_density",
]
