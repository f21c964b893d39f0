"""Experiment configuration dataclasses.

Schema-compatible with the reference's dataclass_json classes
(ref: GPSat/config_dataclasses.py:11,221,333,450,514,552), including the
legacy JSON field-name mapping on ExperimentConfig:
  data_config <-> "data", model_config <-> "model",
  expert_locs_config <-> "locations", prediction_locs_config <-> "pred_loc",
  run_config <-> "run_kwargs".

Old GPSat JSON configs therefore load unchanged via
``ExperimentConfig.from_dict(json.load(f))``. The port's own copy of
``gpsat_tpu/config.py``; pandas is imported with it (the field types name
``pd.DataFrame``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import pandas as pd

from gpsat_tpu_torch.utils.misc import nested_dict_literal_eval


def _asdict(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        out[f.name] = v
    return out


@dataclass
class DataConfig:
    data_source: Union[str, pd.DataFrame, dict, None] = None
    table: Optional[str] = None
    obs_col: Optional[str] = None
    coords_col: Optional[List[str]] = None
    local_select: Optional[List[dict]] = None
    global_select: Optional[List[dict]] = None
    row_select: Optional[List[dict]] = None
    col_select: Optional[List[str]] = None
    col_funcs: Union[List[str], dict, None] = None
    engine: Optional[str] = None
    read_kwargs: Optional[dict] = None

    def to_dict(self):
        return _asdict(self)

    to_dict_with_dataframe = to_dict

    @classmethod
    def from_dict(cls, d: dict):
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})


@dataclass
class ModelConfig:
    oi_model: Union[str, dict, None] = None
    init_params: Optional[dict] = None
    constraints: Optional[Dict[str, dict]] = None
    load_params: Optional[dict] = None
    optim_kwargs: Optional[dict] = None
    pred_kwargs: Optional[dict] = None
    params_to_store: Union[str, List[str]] = "all"
    replacement_threshold: Optional[int] = None
    replacement_model: Optional[str] = None
    replacement_init_params: Optional[dict] = None
    replacement_constraints: Optional[dict] = None
    replacement_optim_kwargs: Optional[dict] = None
    replacement_pred_kwargs: Optional[dict] = None

    def to_dict(self):
        out = _asdict(self)
        out.setdefault("params_to_store", "all")
        return out

    @classmethod
    def from_dict(cls, d: dict):
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})


@dataclass
class ExpertLocsConfig:
    source: Union[str, pd.DataFrame, dict, None] = None
    where: Union[dict, List[dict], None] = None
    add_data_to_col: Optional[dict] = None
    col_funcs: Optional[Dict[str, dict]] = None
    col_select: Optional[List[str]] = None
    row_select: Optional[List[dict]] = None
    reset_index: bool = False
    source_kwargs: Optional[dict] = None
    verbose: bool = False
    sort_by: Union[str, List[str], None] = None
    # legacy fields
    df: Optional[pd.DataFrame] = None
    file: Optional[str] = None
    keep_cols: Optional[list] = None

    def to_dict(self):
        out = _asdict(self)
        out.pop("reset_index", None) if self.reset_index is False else None
        out.pop("verbose", None) if self.verbose is False else None
        return out

    to_dict_with_dataframe = to_dict

    @classmethod
    def from_dict(cls, d: dict):
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})


@dataclass
class PredictionLocsConfig:
    method: str = "expert_loc"
    coords_col: Optional[List[str]] = None
    df: Union[pd.DataFrame, dict, None] = None
    df_file: Optional[str] = None
    max_dist: Union[int, float, None] = None
    load_kwargs: Optional[dict] = None
    # extra kwargs (e.g. shift arrays per coordinate) pass through
    extra: dict = field(default_factory=dict)

    def to_dict(self):
        out = _asdict(self)
        extra = out.pop("extra", {})
        out.update(extra)
        return out

    to_dict_with_dataframe = to_dict

    @classmethod
    def from_dict(cls, d: dict):
        known = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        kw = {k: v for k, v in d.items() if k in known}
        kw["extra"] = {k: v for k, v in d.items() if k not in known}
        return cls(**kw)


@dataclass
class RunConfig:
    store_path: Optional[str] = None
    store_every: int = 10
    check_config_compatible: bool = True
    skip_valid_checks_on: Optional[list] = None
    optimise: bool = True
    predict: bool = True
    min_obs: int = 3
    table_suffix: str = ""

    def to_dict(self):
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: dict):
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})


_LEGACY_NAMES = {
    "data_config": "data",
    "model_config": "model",
    "expert_locs_config": "locations",
    "prediction_locs_config": "pred_loc",
    "run_config": "run_kwargs",
}


@dataclass
class ExperimentConfig:
    data_config: DataConfig = field(default_factory=DataConfig)
    model_config: ModelConfig = field(default_factory=ModelConfig)
    expert_locs_config: ExpertLocsConfig = field(default_factory=ExpertLocsConfig)
    prediction_locs_config: PredictionLocsConfig = field(default_factory=PredictionLocsConfig)
    run_config: RunConfig = field(default_factory=RunConfig)
    comment: Optional[str] = None

    def to_dict(self) -> dict:
        """Legacy-named dict (data/model/locations/pred_loc/run_kwargs)."""
        out = {
            "data": self.data_config.to_dict(),
            "model": self.model_config.to_dict(),
            "locations": self.expert_locs_config.to_dict(),
            "pred_loc": self.prediction_locs_config.to_dict(),
            "run_kwargs": self.run_config.to_dict(),
        }
        if self.comment:
            out["comment"] = self.comment
        return out

    to_dict_with_dataframe = to_dict

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        d = nested_dict_literal_eval(d)
        get = lambda *names: next((d[n] for n in names if n in d), {})
        return cls(
            data_config=DataConfig.from_dict(get("data", "data_config")),
            model_config=ModelConfig.from_dict(get("model", "model_config")),
            expert_locs_config=ExpertLocsConfig.from_dict(get("locations", "expert_locs_config", "local_expert_locations")),
            prediction_locs_config=PredictionLocsConfig.from_dict(get("pred_loc", "prediction_locs_config", "pred_loc_config")),
            run_config=RunConfig.from_dict(get("run_kwargs", "run_config")),
            comment=d.get("comment"),
        )

    @classmethod
    def from_json(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))
