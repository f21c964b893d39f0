"""Legacy import path (ref: GPSat/config_dataclasses.py exports the
experiment config dataclasses). Implementation: config.py."""

from gpsat_tpu_torch.config import (  # noqa: F401
    DataConfig,
    ExperimentConfig,
    ExpertLocsConfig,
    ModelConfig,
    PredictionLocsConfig,
    RunConfig,
)

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "ExpertLocsConfig",
    "ModelConfig",
    "PredictionLocsConfig",
    "RunConfig",
]
