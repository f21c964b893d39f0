"""Legacy import path (ref: GPSat/models/pure_python_gpr.py); the code is in pure_numpy_gpr.py."""

from gpsat_tpu_torch.models.pure_numpy_gpr import GPR, Nystroem, PureNumpyGPR as PurePythonGPR, SGPkernel, SMLII_mod  # noqa: F401
