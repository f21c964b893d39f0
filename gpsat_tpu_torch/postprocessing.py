"""CLI and re-exports: hyperparameter smoothing (ref: GPSat/postprocessing.py:601-609).

Usage: python -m gpsat_tpu_torch.postprocessing <config.json>

Config keys (those of the JAX package's CLI): result_file, params_to_smooth,
smooth_config_dict, xy_dims, reference_table_suffix, table_suffix,
output_file, model_name, save_config_file, and the port's ``device``
("cpu", or a CUDA device; the default is the card). The emitted
predict-only config runs with ``python -m gpsat_tpu_torch.local_expert_oi``.
"""

from gpsat_tpu_torch.postprocess import (  # noqa: F401
    SmoothingConfig,
    gaussian_2d_weight,
    glue_local_predictions,
    glue_local_predictions_1d,
    glue_local_predictions_2d,
    smooth_hyperparameters,
)
from gpsat_tpu_torch.utils.misc import cprint, get_config_from_sysargv


def get_smooth_params_config():
    """Config from sys.argv, falling back to the example postprocessing
    config with example result paths (ref: GPSat/postprocessing.py:580-599)."""
    import json
    import warnings

    from gpsat_tpu_torch import get_config_path, get_parent_path
    from gpsat_tpu_torch.utils.misc import json_serializable, nested_dict_literal_eval

    config = get_config_from_sysargv()
    if config is None:
        config_file = get_config_path("example_postprocessing.json")
        warnings.warn(f"\nconfig is empty / not provided, will just use an example config:\n{config_file}")
        with open(config_file, "r") as f:
            config = nested_dict_literal_eval(json.load(f))
        config["result_file"] = get_parent_path("results", "example", "ABC_binned_example.h5")
        config["output_file"] = get_parent_path("results", "example", "ABC_binned_example.h5")
        cprint("example config being used:", c="BOLD")
        cprint(json.dumps(json_serializable(config), indent=4), c="HEADER")
    return config


def main(config: dict = None):
    if config is None:
        config = get_config_from_sysargv()
    assert config is not None, "no config provided; usage: python -m gpsat_tpu_torch.postprocessing <config.json>"
    config = dict(config)
    config.pop("comment", None)
    out_cfg = smooth_hyperparameters(**config)
    cprint(f"done; predict-only config: {out_cfg}", c="OKGREEN")
    return out_cfg


if __name__ == "__main__":
    main()
