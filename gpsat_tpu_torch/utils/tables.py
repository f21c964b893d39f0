"""Table <-> array marshalling (ref: GPSat/utils.py:1437-1786).

The port's own copy of ``gpsat_tpu/utils/tables.py``.

n-d parameter arrays round-trip through 2-d tables with ``_dim_k`` index
columns — the storage representation of hyperparameters in results files.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import pandas as pd


def match(x, y) -> np.ndarray:
    """Index positions of x's entries in array y (ref: utils.py match)."""
    xs = [x] if isinstance(x, str) else list(np.atleast_1d(x))
    y = list(y)
    return np.array([y.index(v) for v in xs])


def array_to_dataframe(x, name: str, dim_prefix: str = "_dim_", reset_index: bool = False) -> pd.DataFrame:
    """n-d array -> DataFrame with a _dim_* multi-index (ref: utils.py:1437)."""
    if isinstance(x, (int, float, bool, str)):
        x = np.array([x])
    assert isinstance(x, np.ndarray), f"expected ndarray, got: {type(x)}"
    shape = x.shape
    dim_names = [f"{dim_prefix}{i}" for i in range(len(shape))]
    midx = pd.MultiIndex.from_product([np.arange(i) for i in shape], names=dim_names)
    out = pd.DataFrame(x.flat, index=midx, columns=[name])
    if reset_index:
        out = out.reset_index()
    return out


def dataframe_to_array(df: pd.DataFrame, val_col: str, idx_col=None, dropna: bool = True, fill_val=np.nan) -> np.ndarray:
    """Inverse of array_to_dataframe (ref: utils.py:1498)."""
    if idx_col is None:
        if dropna:
            df = df[[val_col]].dropna()
        idx = df.index
        if isinstance(idx, pd.MultiIndex):
            idx_vals = np.array(idx.values.tolist())
            dims = {dn: idx_vals[:, i] for i, dn in enumerate(idx.names)}
        else:
            dims = {idx.names[0]: idx.values}
    else:
        if dropna:
            df = df.loc[~pd.isnull(df[val_col])]
        idx_col = idx_col if isinstance(idx_col, list) else [idx_col]
        assert all(c in df.columns for c in idx_col), f"idx_col {idx_col} not all in columns"
        dims = {ic: df[ic].values for ic in idx_col}

    for k, v in dims.items():
        v = np.asarray(v)
        assert np.issubdtype(v.dtype, np.integer), f"'{k}' dimension must be integer, got: {v.dtype}"
        assert v.min() == 0, f"'{k}' dimension must start at 0"
        if len(np.unique(v)) > 1:
            assert np.max(np.diff(np.unique(v))) == 1, f"'{k}' dimension has gaps"

    shape = tuple(len(np.unique(np.asarray(v))) for v in dims.values())
    out = np.full(shape, fill_val, dtype=df[val_col].dtype)
    out[tuple(np.asarray(v) for v in dims.values())] = df[val_col].values
    return out


def dict_of_array_to_dict_of_dataframe(array_dict: dict, concat: bool = False, reset_index: bool = False) -> dict:
    """Dict of arrays -> dict of DataFrames; with concat, same-ndim arrays
    merge into one table keyed by ndim (ref: utils.py:1619)."""
    out = {}
    if not concat:
        for k, v in array_dict.items():
            out[k] = array_to_dataframe(np.asarray(v) if not np.isscalar(v) else v, k, reset_index=reset_index)
        return out
    by_ndim = {}
    for k, v in array_dict.items():
        arr = np.array([v]) if np.isscalar(v) else np.asarray(v)
        by_ndim.setdefault(arr.ndim, []).append(array_to_dataframe(arr, k))
    for nd, dfs in by_ndim.items():
        merged = pd.concat(dfs, axis=1)
        if reset_index:
            merged = merged.reset_index()
        out[nd] = merged
    return out


def make_multiindex_df(idx_dict: Union[dict, pd.Series], **kwargs) -> dict:
    """Attach a constant (expert-location) multi-index to each table
    (ref: dataloader.py:2451)."""
    if isinstance(idx_dict, pd.Series):
        idx_dict = idx_dict.to_dict()
    out = {}
    for k, df in kwargs.items():
        if isinstance(df, np.ndarray):
            df = array_to_dataframe(df, k, reset_index=True)
        df = df.copy()
        midx = pd.MultiIndex.from_tuples([tuple(idx_dict.values())] * len(df), names=list(idx_dict.keys()))
        df.index = midx
        out[k] = df
    return out


def mindex_df_to_dataarray(df: pd.DataFrame, data_name: str, dim_prefix: str = "_dim_", infer_dim_cols: bool = True):
    """Read an n-d parameter back out of its table rows: returns
    (values [n_locs, *param_shape], location index) —
    the xarray-free analogue of mindex_df_to_mindex_dataarray
    (ref: dataloader.py:2529)."""
    dim_cols = sorted(c for c in df.columns if c.startswith(dim_prefix)) if infer_dim_cols else []
    locs = df.index.unique()
    vals = []
    for loc in locs:
        g = df.loc[[loc]]
        if dim_cols:
            g = g.sort_values(dim_cols)
            shape = tuple(g[c].max() + 1 for c in dim_cols)
            vals.append(np.asarray(g[data_name].values).reshape(shape))
        else:
            vals.append(np.asarray(g[data_name].values))
    return np.stack(vals), locs


def dataframe_to_2d_array(df: pd.DataFrame, x_col: str, y_col: str, val_col: str, fill_val=np.nan, dtype=None, **kwargs):
    """Values assumed sampled from a 2-d grid -> dense array + axes
    (ref: utils.py:2230)."""
    x_vals = np.sort(df[x_col].unique())
    y_vals = np.sort(df[y_col].unique())
    out = np.full((len(y_vals), len(x_vals)), fill_val, dtype=dtype or float)
    xi = np.searchsorted(x_vals, df[x_col].values)
    yi = np.searchsorted(y_vals, df[y_col].values)
    out[yi, xi] = df[val_col].values
    return out, x_vals, y_vals


def pip_freeze_to_dataframe() -> pd.DataFrame:
    """Installed-package table for provenance (ref: utils.py:2589)."""
    import importlib.metadata as md

    rows = [(d.metadata["Name"], d.version) for d in md.distributions() if d.metadata["Name"]]
    return pd.DataFrame(sorted(rows), columns=["package", "version"])
