"""CLI: run local-expert optimal interpolation from a JSON config
(ref: examples/local_expert_oi.py:34-145).

Usage: python -m gpsat_tpu_torch.local_expert_oi <config.json>

The JSON may be a single experiment config or a list of them; each has the
reference's keys: data, model, locations, pred_loc, run_kwargs (+ optional
comment, misc). run_kwargs may carry ``mesh`` ("all", an int or a list of
devices; the default is every visible card), ``device`` ("cpu", or one
CUDA device) and ``dtype`` ("float32", the default, or "float64").
"""

import json

from gpsat_tpu_torch.experts import LocalExpertOI
from gpsat_tpu_torch.utils.misc import cprint, get_config_from_sysargv, nested_dict_literal_eval


def get_local_expert_oi_configs(path_or_dict=None):
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            cfg = nested_dict_literal_eval(json.load(f))
    elif path_or_dict is None:
        cfg = get_config_from_sysargv()
    else:
        cfg = path_or_dict
    assert cfg is not None, "no config provided; usage: python -m gpsat_tpu_torch.local_expert_oi <config.json>"
    return cfg if isinstance(cfg, list) else [cfg]


def run_from_config(config: dict):
    config = dict(config)
    config.pop("comment", None)
    config.pop("misc", None)
    run_kwargs = dict(config.pop("run_kwargs", {}))
    oi = LocalExpertOI(
        expert_loc_config=config.get("locations"),
        data_config=config.get("data"),
        model_config=config.get("model"),
        pred_loc_config=config.get("pred_loc"),
    )
    oi.run(**run_kwargs)
    return oi


def main(path_or_dict=None):
    configs = get_local_expert_oi_configs(path_or_dict)
    for i, cfg in enumerate(configs):
        cprint(f"--- running OI config {i + 1} / {len(configs)} ---", c="OKBLUE")
        run_from_config(cfg)


if __name__ == "__main__":
    main()
