"""Legacy import path (ref: GPSat/models/base_model.py); the class is in base.py."""

from gpsat_tpu_torch.models.base import BaseGPRModel  # noqa: F401
