"""Legacy import path (ref: GPSat/models/gpytorch_models.py); the classes are in torch_gpr.py."""

from gpsat_tpu_torch.models.torch_gpr import TorchGPRModel as GPyTorchGPRModel, TorchKISSGPModel as GPyTorchKISSGPModel  # noqa: F401
