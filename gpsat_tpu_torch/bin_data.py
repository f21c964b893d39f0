"""CLI: bin raw observations onto a regular grid (ref: GPSat/bin_data.py).

Usage: python -m gpsat_tpu_torch.bin_data <config.json>
   or: python -m gpsat_tpu_torch.cli bin_data <config.json>

The port's copy of ``gpsat_tpu/bin_data.py``. Config keys
(reference-compatible): input {source/file, table, where, batch, load_by,
...}, bin_config {by_cols, val_col, grid_res, x_range, y_range,
bin_statistic, ...}, output {file, table}, add_output_cols. Other keys
(the reference's ``plot``, say) are not read, as in the JAX package.

``plot_wrapper`` is re-exported from ``plot_utils`` under the reference's
module path (ref: bin_data.py:764) through the module's ``__getattr__``, so
importing this module imports no matplotlib.
"""

import sys

# the library surface under the reference's module path
from gpsat_tpu_torch.data.binning import BinData, bin_data, bin_data_by  # noqa: F401
from gpsat_tpu_torch.utils.misc import cprint, get_config_from_sysargv

USAGE = "usage: python -m gpsat_tpu_torch.bin_data <config.json>"


def __getattr__(name):
    if name == "plot_wrapper":
        from gpsat_tpu_torch.plot_utils import plot_wrapper

        return plot_wrapper
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_bin_data_config():
    """Config from sys.argv, falling back to the example bin config with
    example data paths (ref: GPSat/bin_data.py:853-875)."""
    import json
    import os
    import warnings

    from gpsat_tpu_torch import get_config_path, get_parent_path
    from gpsat_tpu_torch.utils.misc import nested_dict_literal_eval

    config = get_config_from_sysargv()
    if config is None:
        config_file = get_config_path("example_bin_raw_data.json")
        warnings.warn(f"\nconfig is empty / not provided, will just use an example config:\n{config_file}")
        with open(config_file, "r") as f:
            config = nested_dict_literal_eval(json.load(f))
        config["input"]["file"] = get_parent_path("data", "example", "ABC.h5")
        config["output"]["file"] = get_parent_path("data", "example", "ABC_binned.h5")
        assert os.path.exists(config["input"]["file"]), (
            f"config['input']['file']:\n{config['input']['file']}\ndoes not exist. "
            f"to create run: python -m gpsat_tpu_torch.read_and_store"
        )
    return config


def main(config: dict = None):
    """Bin one config; without one (none given here and none on the command
    line) print the usage and return 2."""
    if config is None:
        config = get_config_from_sysargv()
    if config is None:
        print(USAGE, file=sys.stderr)
        return 2
    config = dict(config)
    config.pop("comment", None)
    df_bin, stats = BinData().bin_data(
        input=config.get("input"),
        bin_config=config.get("bin_config"),
        output=config.get("output"),
        add_output_cols=config.get("add_output_cols"),
    )
    if df_bin is not None:
        cprint(f"binned {len(df_bin)} cells", c="OKGREEN")
    return df_bin, stats


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
