"""Legacy import path (ref: GPSat/models/asvgp_model.py); the class is in asvgp.py."""

from gpsat_tpu_torch.models.asvgp import ASVGPModel as GPflowASVGPModel  # noqa: F401
