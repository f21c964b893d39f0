"""DataPrep module alias (reference path: GPSat/dataprepper.py); the port's
own copy of ``gpsat_tpu/dataprepper.py``."""

from gpsat_tpu_torch.data.binning import bin_data, bin_data_by  # noqa: F401
from gpsat_tpu_torch.dataloader import DataPrep  # noqa: F401
