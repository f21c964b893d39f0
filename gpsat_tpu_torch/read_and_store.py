"""CLI: raw flat files -> observations table (ref: GPSat/read_and_store.py).

Usage: python -m gpsat_tpu_torch.read_and_store <config.json>
   or: python -m gpsat_tpu_torch.cli read_and_store <config.json>

The port's copy of ``gpsat_tpu/read_and_store.py``. Config keys
(reference-compatible): output {file, table}, file_dirs / base_dirs,
sub_dirs, file_regex, col_funcs, row_select, col_select, read_engine,
read_kwargs, batch. The table is written in the port's ``TableStore``
format, which the JAX package reads too.
"""

import sys

from gpsat_tpu_torch.data.ingest import get_dirs_to_search, read_and_store  # noqa: F401
from gpsat_tpu_torch.utils.misc import cprint, get_config_from_sysargv

USAGE = "usage: python -m gpsat_tpu_torch.read_and_store <config.json>"


def update_attr(x, cid, vals):
    """Copy-modify-return an attrs dict (HDF attrs don't update in place;
    ref: GPSat/read_and_store.py:19-27)."""
    assert isinstance(x, dict)
    tmp = x.copy()
    tmp[cid] = vals
    return tmp


def main(config: dict = None):
    """Run one config; without one (none given here and none on the command
    line) print the usage and return 2."""
    if config is None:
        config = get_config_from_sysargv()
    if config is None:
        print(USAGE, file=sys.stderr)
        return 2
    config = dict(config)
    config.pop("comment", None)
    output = config.pop("output")
    file_dirs = config.pop("file_dirs", config.pop("base_dirs", None))
    file_regex = config.pop("file_regex")
    out = read_and_store(output=output, file_dirs=file_dirs, file_regex=file_regex, **config)
    cprint(f"done; observations stored in: {out}", c="OKGREEN")
    return out


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
