"""Legacy import path (ref: GPSat/models/multioutput/likelihoods.py
exports the forward-model likelihood classes)."""

from gpsat_tpu_torch.models.multioutput.core import (  # noqa: F401
    ForwardModelLikelihood,
    LinearModelLikelihood,
    NonlinearModelLikelihood,
)

__all__ = ["ForwardModelLikelihood", "LinearModelLikelihood", "NonlinearModelLikelihood"]
