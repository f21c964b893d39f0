"""Legacy import path (ref: GPSat/models/vff_model.py); the class is in vff.py."""

from gpsat_tpu_torch.models.vff import VFFModel as GPflowVFFModel  # noqa: F401
