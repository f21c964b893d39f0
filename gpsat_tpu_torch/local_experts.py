"""Legacy import path (ref: GPSat/local_experts.py); the code is in experts.py."""

from gpsat_tpu_torch.experts import LocalExpertData, LocalExpertOI, get_results_from_h5file  # noqa: F401
