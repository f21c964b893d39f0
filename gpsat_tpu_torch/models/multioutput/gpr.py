"""Legacy import path (ref: GPSat/models/multioutput/gpr.py exports
MultioutputGPR / MultioutputSVGP). The implementations live in
core.py under the *Model names."""

from gpsat_tpu_torch.models.multioutput.core import (  # noqa: F401
    MultioutputGPRModel,
    MultioutputGPRModel as MultioutputGPR,
    MultioutputSVGPModel,
    MultioutputSVGPModel as MultioutputSVGP,
)

__all__ = ["MultioutputGPR", "MultioutputSVGP", "MultioutputGPRModel", "MultioutputSVGPModel"]
