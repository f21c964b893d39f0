"""CLI: bin raw observations onto a regular grid (ref: GPSat/bin_data.py).

Usage: python -m gpsat_tpu_torch.bin_data <config.json>
   or: python -m gpsat_tpu_torch.cli bin_data <config.json>

The port's copy of ``gpsat_tpu/bin_data.py``. Config keys
(reference-compatible): input {source/file, table, where, batch, load_by,
...}, bin_config {by_cols, val_col, grid_res, x_range, y_range,
bin_statistic, ...}, output {file, table}, add_output_cols. A config
asking for the reference's plots (``plot``) raises: they need
``plot_utils``, which is not ported yet.
"""

import sys

# the library surface under the reference's module path
from gpsat_tpu_torch.data.binning import BinData, bin_data, bin_data_by  # noqa: F401
from gpsat_tpu_torch.utils.misc import cprint, get_config_from_sysargv

USAGE = "usage: python -m gpsat_tpu_torch.bin_data <config.json>"


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
    if config.get("plot"):
        raise NotImplementedError("bin_data's plots need plot_utils, which is not ported yet; see ROADMAP.md "
                                  "Queue 1 item 9")
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
