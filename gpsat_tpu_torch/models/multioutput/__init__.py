"""Multi-output GP package (experimental, reference-path layout).

Mirrors the reference's GPSat/models/multioutput/ package structure
(gpr.py / likelihoods.py / utils.py); the implementation lives in
core.py and the submodules re-export it at the reference paths.
"""

from gpsat_tpu_torch.models.multioutput.core import (  # noqa: F401
    ForwardModel,
    ForwardModelLikelihood,
    LinearForwardModel,
    LinearModelLikelihood,
    MultioutputGPRModel,
    MultioutputGPRModel as MultioutputGPR,
    MultioutputSVGPModel,
    MultioutputSVGPModel as MultioutputSVGP,
    NonlinearModelLikelihood,
    add_likelihood_noise_cov,
    latent_gram,
    mo_gpr_lml,
    mo_gpr_predict,
    mo_svgp_elbo,
    multioutput_conditional,
    multivariate_gaussian_log_density,
    observed_cov,
)

__all__ = [
    "ForwardModel",
    "ForwardModelLikelihood",
    "LinearForwardModel",
    "LinearModelLikelihood",
    "MultioutputGPR",
    "MultioutputSVGP",
    "MultioutputGPRModel",
    "MultioutputSVGPModel",
    "NonlinearModelLikelihood",
    "add_likelihood_noise_cov",
    "latent_gram",
    "mo_gpr_lml",
    "mo_gpr_predict",
    "mo_svgp_elbo",
    "multioutput_conditional",
    "multivariate_gaussian_log_density",
    "observed_cov",
]
