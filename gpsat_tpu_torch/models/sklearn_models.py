"""Legacy import path (ref: GPSat/models/sklearn_models.py); the class is in sklearn_model.py."""

from gpsat_tpu_torch.models.sklearn_model import SklearnGPRModel as sklearnGPRModel  # noqa: F401
