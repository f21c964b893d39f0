"""Data loading: source -> filtered, column-derived DataFrame.

The port's own copy of ``gpsat_tpu/data/dataloader.py::load`` and
``add_cols`` (ref: GPSat/dataloader.py:1294-1800): suffix-based engine
inference, where pushdown, col_funcs (derived columns via config_func,
including tuple-key multi-output), row_select, col_select.

Sources: a DataFrame (or a dict of columns), a CSV/TSV file, an HDF5
table through the port's ``TableStore`` or, for a reference-produced
pandas-HDFStore (PyTables) file, ``data/pytables_compat``; a parquet file
(pandas with pyarrow, imported when one is read; {col, comp, val} wheres go
down as pyarrow filters); a netCDF4 file (``data/netcdf``, through the
port's own HDF5 codec) and a zarr v2 store (``data/zarr_reader``: stdlib, numpy
and pandas, blosc chunks through the C++ host library). netCDF and zarr
sources come back with their dimensions reset to columns. pandas is
imported when ``load`` runs.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Union

from gpsat_tpu_torch.data import select as sel
from gpsat_tpu_torch.data import pytables_compat as PT
from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.utils.config_func import config_func

FILE_SUFFIX_ENGINE_MAP = {
    "csv": "read_csv",
    "tsv": "read_csv",
    "h5": "tablestore",
    "hdf5": "tablestore",
    "parquet": "parquet",
    "zarr": "zarr",
    "nc": "netcdf4",
}
def add_cols(df, col_func_dict: Optional[dict] = None, filename=None, verbose: bool = False):
    """Add derived columns in place; tuple keys assign multiple columns
    (ref: GPSat/dataloader.py:46-134)."""
    if col_func_dict is None:
        col_func_dict = {}
    for new_col, col_fun in col_func_dict.items():
        if isinstance(new_col, tuple):
            new_col = list(new_col)
            vals = config_func(df=df, filename=filename, **col_fun)
            assert len(vals) == len(new_col), (
                f"columns: {new_col} have length: {len(new_col)} but function returned {len(vals)} outputs"
            )
            for i, v in enumerate(vals):
                df[new_col[i]] = v
        else:
            df[new_col] = config_func(df=df, filename=filename, **col_fun)


def _infer_engine(source: str) -> str:
    suffix = re.sub("^.*\\.", "", source).lower()
    assert suffix in FILE_SUFFIX_ENGINE_MAP, (
        f"could not infer engine from suffix: '{suffix}'; known: {FILE_SUFFIX_ENGINE_MAP}"
    )
    return FILE_SUFFIX_ENGINE_MAP[suffix]


def load(
    source: Union[str, "pd.DataFrame", TableStore, dict],  # noqa: F821
    where: Optional[Union[dict, List[dict]]] = None,
    table: Optional[str] = None,
    col_funcs: Optional[dict] = None,
    row_select: Optional[List[dict]] = None,
    col_select: Optional[List[str]] = None,
    engine: Optional[str] = None,
    source_kwargs: Optional[dict] = None,
    reset_index: bool = False,
    combine_row_select: str = "AND",
    verbose: bool = False,
    **kwargs,
):
    """Load + select + derive columns, in the reference's order:
    where-pushdown -> col_funcs -> row_select -> col_select."""
    import pandas as pd

    source_kwargs = source_kwargs or {}
    if isinstance(where, dict):
        where = [where]

    if isinstance(source, dict):
        if "_dataframe_" in source:
            raise ValueError(
                "source is a serialized DataFrame fingerprint — in-memory "
                "DataFrame sources don't survive a JSON round trip; use a "
                "file path in configs written to disk"
            )
        # a DataFrame expressed as a column dict in a JSON config
        source = pd.DataFrame(source)
    if isinstance(source, pd.DataFrame):
        df = sel.data_select(source, where=where)
    elif isinstance(source, TableStore):
        assert table is not None, "table must be provided when loading from a TableStore"
        df = source.select(table, where=where).reset_index()
    else:
        assert isinstance(source, str), f"source type not handled: {type(source)}"
        assert os.path.exists(source), f"source file does not exist: {source}"
        eng = engine or _infer_engine(source)
        if eng == "read_csv":
            df = pd.read_csv(source, **source_kwargs)
            df = sel.data_select(df, where=where)
        elif eng == "tablestore":
            assert table is not None, "table must be provided when loading from an h5 store"
            if PT.is_pytables_store(source):
                df = PT.read_table(source, table, where=where)
                drop = all(n is None for n in df.index.names)
                df = df.reset_index(drop=drop)
            else:
                with TableStore(source, mode="r") as ts:
                    df = ts.select(table, where=where).reset_index()
        elif eng == "parquet":
            filters = _wheres_to_parquet_filter(where)
            df = pd.read_parquet(source, filters=filters, **source_kwargs)
            if where:
                df = sel.data_select(df, where=where)
        elif eng == "netcdf4":
            # the reference reads nc through xr.open_dataset + to_dataframe
            # (GPSat/dataloader.py:388-394); netCDF4 files are HDF5
            from gpsat_tpu_torch.data.netcdf import read_netcdf

            df = read_netcdf(source, **source_kwargs).reset_index()
            df = sel.data_select(df, where=where)
        elif eng == "zarr":
            # zarr v2 DirectoryStore (ref: GPSat/dataloader.py:1239-1254)
            from gpsat_tpu_torch.data.zarr_reader import read_zarr

            df = read_zarr(source, **source_kwargs).reset_index()
            df = sel.data_select(df, where=where)
        else:
            raise ValueError(f"engine: {eng} not handled")

    add_cols(df, col_funcs, filename=source if isinstance(source, str) else None, verbose=verbose)

    if row_select is not None:
        df = df.loc[sel.row_select_bool(df, row_select, combine=combine_row_select)]

    if col_select is not None:
        df = df.loc[:, col_select]

    if reset_index:
        df = df.reset_index(drop=True)
    return df


def _wheres_to_parquet_filter(where):
    """{col, comp, val} dicts -> pyarrow filter tuples
    (ref: GPSat/dataloader.py:1275-1288)."""
    if not where:
        return None
    out = []
    for wd in where:
        if isinstance(wd, dict) and all(k in wd for k in ("col", "comp", "val")) and not wd.get("negate"):
            out.append((wd["col"], wd["comp"], wd["val"]))
    return out or None


def add_data_to_col(df, add_data_to_col: Optional[dict] = None, verbose: bool = False):
    """Set a column to each value in turn, replicating the rows per value
    (ref: GPSat/dataloader.py add_data_to_col — a scalar sets one column;
    a list of k values concatenates k copies of the DataFrame, one per
    value)."""
    import numpy as np
    import pandas as pd

    if add_data_to_col is None:
        add_data_to_col = {}
    assert isinstance(add_data_to_col, dict), (
        f"add_data_to_col expected to be dict, got: {type(add_data_to_col)}"
    )
    for col, vals in add_data_to_col.items():
        if not isinstance(vals, (list, tuple, np.ndarray)):
            vals = [vals]
        if verbose:
            print(f"adding column: {col} with {len(vals)} value(s)")
        parts = []
        for v in vals:
            tmp = df.copy(True)
            tmp[col] = v
            parts.append(tmp)
        df = pd.concat(parts, axis=0)
    return df
