"""Legacy import path (ref: GPSat/prediction_locations.py exports
PredictionLocations). Implementation: data/prediction_locations.py (the
host library's grid-hash radius filter in place of the reference's numba
guvectorize kernel, prediction_locations.py:18-43)."""

from gpsat_tpu_torch.data.prediction_locations import PredictionLocations  # noqa: F401

__all__ = ["PredictionLocations"]
