"""Legacy import path (ref: GPSat/models/gpflow_models.py); the classes are in gpr.py, sgpr.py and svgp.py."""

from gpsat_tpu_torch.models.gpr import GPRModel as GPflowGPRModel  # noqa: F401
from gpsat_tpu_torch.models.sgpr import SGPRModel as GPflowSGPRModel  # noqa: F401
from gpsat_tpu_torch.models.svgp import SVGPModel as GPflowSVGPModel  # noqa: F401
