"""Observation binning: raw scattered obs -> regular-grid cell statistics.

The port's own copy of ``gpsat_tpu/data/binning.py``; the output is
written to the port's ``TableStore`` (the JAX package's format). Re-implements the reference's binning stack:
- ``bin_data`` / ``bin_data_by`` (ref: GPSat/dataprepper.py:23-401) on
  scipy.stats.binned_statistic(_2d) with identical edge/center conventions
  (x is dim 1, y dim 0; default ±4,500 km EASE2 domain). The reference
  returns an xarray Dataset; xarray is not in this image, so the native
  output is the equivalent *long* DataFrame (what the reference produces
  anyway via ``ds.to_dataframe().dropna()`` before storage,
  ref: bin_data.py:268-271).
- ``BinData`` (ref: GPSat/bin_data.py:87-760): config-driven pipeline with
  all-at-once and batch modes, stats reporting, and output written to the
  TableStore with raw/bin config + run info attached as attrs.
"""

from __future__ import annotations

import types
from typing import List, Optional, Union

import numpy as np
import pandas as pd

from gpsat_tpu_torch.data import dataloader as DL
from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.utils.misc import cprint, json_serializable, stats_on_vals


def bin_data(
    df: pd.DataFrame,
    x_range=None,
    y_range=None,
    grid_res: float = None,
    x_col: str = "x",
    y_col: str = "y",
    val_col: str = None,
    bin_statistic="mean",
    bin_2d: bool = True,
    return_bin_center: bool = True,
):
    """Bin one value column onto a regular grid; returns (array, coords).

    2-d output is transposed so y is dim 0 / x is dim 1, matching the
    reference (ref: dataprepper.py:226-401).
    """
    import scipy.stats as scst

    assert val_col is not None, "val_col cannot be None"
    assert grid_res is not None, "grid_res is None, must be supplied"
    assert len(df) > 0, "dataframe provided must have len > 0"

    if not bin_2d:
        y_col = x_col
    if x_range is None:
        x_range = [-4500000.0, 4500000.0]
    if y_range is None:
        y_range = [-4500000.0, 4500000.0]
    assert len(x_range) == 2 and x_range[0] < x_range[1], f"bad x_range: {x_range}"
    assert len(y_range) == 2 and y_range[0] < y_range[1], f"bad y_range: {y_range}"

    x_min, x_max = x_range
    y_min, y_max = y_range
    n_x = int((x_max - x_min) / grid_res) + 1
    n_y = int((y_max - y_min) / grid_res) + 1
    x_edge = np.linspace(x_min, x_max, n_x)
    y_edge = np.linspace(y_min, y_max, n_y)

    for c in (x_col, y_col, val_col):
        assert c in df, f"column: {c} is not in df columns: {list(df.columns)}"
    x_in, y_in, vals = df[x_col].values, df[y_col].values, df[val_col].values

    if bin_2d:
        binned = scst.binned_statistic_2d(
            x_in, y_in, vals, statistic=bin_statistic, bins=[x_edge, y_edge],
            range=[[x_min, x_max], [y_min, y_max]],
        )
    else:
        binned = scst.binned_statistic(
            x_in, vals, statistic=bin_statistic, bins=x_edge, range=[x_min, x_max]
        )

    if return_bin_center:
        x_out = x_edge[:-1] + np.diff(x_edge) / 2
        y_out = y_edge[:-1] + np.diff(y_edge) / 2
    else:
        x_out, y_out = x_edge, y_edge

    if bin_2d:
        return binned[0].T, (x_out, y_out)
    return binned[0].T, x_out


def _stat_name(val_col, bin_stat, idx, n_stats):
    if n_stats == 1:
        return val_col
    if isinstance(bin_stat, str):
        return f"{val_col}_{bin_stat}"
    if isinstance(bin_stat, (types.FunctionType, types.BuiltinFunctionType)):
        return f"{val_col}_{bin_stat.__name__}"
    return f"{val_col}_{idx}"


def bin_data_by(
    df: pd.DataFrame,
    col_funcs: Optional[dict] = None,
    row_select=None,
    by_cols: Union[str, List[str], None] = None,
    val_col: str = None,
    x_col: str = "x",
    y_col: str = "y",
    x_range=None,
    y_range=None,
    grid_res: float = None,
    bin_statistic="mean",
    bin_2d: bool = True,
    limit: int = 10_000,
    verbose: bool = False,
    return_xarray: bool = False,
):
    """Bin per unique combination of ``by_cols``; returns a long DataFrame
    indexed by (y, x[, by_cols...]) with one column per statistic, NaN
    cells included (drop with .dropna()).

    ``return_xarray=True`` returns the reference's native surface instead —
    an ``xarray.Dataset`` with dims (y, x[, by_cols...]) and one variable
    per statistic (ref: GPSat/dataprepper.py:23-223 returns xr.Dataset).
    Requires xarray to be installed; raises ImportError with guidance
    otherwise (xarray is an optional dependency of this package)."""
    if col_funcs:
        DL.add_cols(df, col_funcs)

    assert by_cols is not None, "by_cols needs to be provided"
    if isinstance(by_cols, str):
        by_cols = [by_cols]
    for bc in by_cols:
        assert bc in df, f"by_cols value: {bc} is not in df.columns: {list(df.columns)}"
    assert val_col in df, f"val_col: {val_col} is not in df.columns"

    if row_select is not None:
        from gpsat_tpu_torch.data import select as sel

        df = sel.data_select(df, where=row_select)

    bc_pair = df.loc[:, by_cols].drop_duplicates()
    assert len(bc_pair) < limit, (
        f"number of unique by_cols combinations: {len(bc_pair)} > limit: {limit}; increase limit if intended"
    )
    bin_statistic = bin_statistic if isinstance(bin_statistic, list) else [bin_statistic]

    frames = []
    for _, bcp in bc_pair.iterrows():
        select = np.ones(len(df), dtype=bool)
        for bc in by_cols:
            select &= (df[bc] == bcp[bc]).values
        df_b = df.loc[select, :]

        block = None
        for bs_ix, bin_stat in enumerate(bin_statistic):
            b, crds = bin_data(
                df_b,
                x_range=x_range,
                y_range=y_range,
                grid_res=grid_res,
                x_col=x_col,
                y_col=y_col,
                val_col=val_col,
                bin_statistic=bin_stat,
                bin_2d=bin_2d,
                return_bin_center=True,
            )
            name = _stat_name(val_col, bin_stat, bs_ix, len(bin_statistic))
            if bin_2d:
                xc, yc = crds
                if block is None:
                    Y, X = np.meshgrid(yc, xc, indexing="ij")
                    block = pd.DataFrame({y_col: Y.ravel(), x_col: X.ravel()})
                block[name] = b.ravel()
            else:
                if block is None:
                    block = pd.DataFrame({x_col: crds})
                block[name] = b
        for bc in by_cols:
            block[bc] = bcp[bc]
        frames.append(block)

    out = pd.concat(frames, axis=0)
    idx_cols = ([y_col, x_col] if bin_2d else [x_col]) + by_cols
    out = out.set_index(idx_cols)
    if return_xarray:
        try:
            import xarray  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "bin_data_by(return_xarray=True) requires xarray, which is "
                "an optional dependency of gpsat_tpu_torch (not in the base image). "
                "Install xarray, or use the default long-DataFrame return "
                "(df.to_xarray() later is equivalent)."
            ) from e
        # long (y, x[, by]) MultiIndex frame -> Dataset with those dims and
        # one variable per statistic — the reference's native surface
        return out.to_xarray()
    return out


class BinData:
    """Config-driven binning pipeline (ref: GPSat/bin_data.py)."""

    def __init__(self, output: Optional[dict] = None):
        self.output = output or {}

    @staticmethod
    def bin_wrapper(df, col_funcs=None, print_stats: bool = True, **bin_config):
        """add_cols + value stats + bin_data_by (ref: bin_data.py:87-178)."""
        if col_funcs is not None:
            DL.add_cols(df, col_func_dict=col_funcs)
        val_col = bin_config["val_col"]
        vals = df[val_col].values
        if np.isnan(vals).all():
            cprint("NaN values found: returning None, None", c="FAIL")
            return None, None
        stats_df = stats_on_vals(
            vals=vals,
            name=val_col,
            qs=[0.001, 0.01, 0.05] + np.arange(0.1, 1.0, 0.1).tolist() + [0.95, 0.99, 0.999],
        )
        if print_stats:
            print(stats_df)
        df_bin = bin_data_by(df=df, **bin_config)
        return df_bin, stats_df

    def bin_data_all_at_once(
        self, file=None, source=None, table=None, where=None, add_output_cols=None, bin_config=None, **load_kwargs
    ):
        assert bin_config is not None and isinstance(bin_config, dict), "bin_config (dict) must be supplied"
        source = source if source is not None else file
        df = DL.load(source=source, table=table, where=where, **load_kwargs)
        df_bin, stats_df = self.bin_wrapper(df, col_funcs=None, print_stats=False, **bin_config)
        if df_bin is None:
            return None, None
        df_bin = df_bin.dropna(how="any").reset_index()
        DL.add_cols(df_bin, col_func_dict=add_output_cols)
        return df_bin, stats_df

    def bin_data_by_batch(
        self,
        file=None,
        source=None,
        table=None,
        where=None,
        load_by=None,
        add_output_cols=None,
        bin_config=None,
        col_funcs=None,
        row_select=None,
        **load_kwargs,
    ):
        """Per-unique-``load_by`` streaming: discover the unique values,
        then load + bin one slice at a time with where-pushdown
        (ref: bin_data.py:280-571 — there via 5M-row HDF5 chunk scans; the
        columnar TableStore reads just the load_by column instead)."""
        assert bin_config is not None, "bin_config must be supplied"
        assert load_by is not None, "load_by must be supplied for batch mode"
        load_by = [load_by] if isinstance(load_by, str) else list(load_by)
        source = source if source is not None else file

        if isinstance(source, str) and source.endswith((".h5", ".hdf5")):
            with TableStore(source, mode="r") as ts:
                ub = ts.select(table, columns=load_by, set_index=False).drop_duplicates()
        else:
            df_all = DL.load(source=source, table=table, where=where)
            ub = df_all[load_by].drop_duplicates()

        out, stats = [], []
        for _, row in ub.iterrows():
            row_where = (where or []) + [
                {"col": c, "comp": "==", "val": row[c]} for c in load_by
            ]
            df = DL.load(source=source, table=table, where=row_where, col_funcs=col_funcs, row_select=row_select, **load_kwargs)
            if len(df) == 0:
                continue
            df_bin, stats_df = self.bin_wrapper(df, col_funcs=None, print_stats=False, **bin_config)
            if df_bin is None:
                continue
            df_bin = df_bin.dropna(how="any").reset_index()
            DL.add_cols(df_bin, col_func_dict=add_output_cols)
            out.append(df_bin)
            if stats_df is not None:
                stats.append(stats_df)
        df_bin = pd.concat(out, axis=0).reset_index(drop=True) if out else None
        stats_df = pd.concat(stats, axis=1) if stats else None
        return df_bin, stats_df

    def bin_data(
        self,
        input: Optional[dict] = None,
        bin_config: Optional[dict] = None,
        output: Optional[dict] = None,
        add_output_cols: Optional[dict] = None,
        batch: bool = False,
        **kwargs,
    ):
        """Top-level dispatch + write (ref: bin_data.py:574-699)."""
        input = input or {}
        output = output or self.output
        if batch or input.get("batch", False):
            df_bin, stats_df = self.bin_data_by_batch(
                add_output_cols=add_output_cols, bin_config=bin_config, **{**input, **kwargs}
            )
        else:
            df_bin, stats_df = self.bin_data_all_at_once(
                add_output_cols=add_output_cols, bin_config=bin_config, **{**input, **kwargs}
            )
        if df_bin is None:
            cprint("no binned output produced", c="FAIL")
            return None, stats_df

        if output.get("file"):
            self.write_dataframe_to_table(
                df_bin,
                file=output["file"],
                table=output.get("table", "data"),
                raw_data_config=input,
                bin_config=bin_config,
            )
        return df_bin, stats_df

    @staticmethod
    def write_dataframe_to_table(df_bin, file, table="data", **config_attrs):
        """Write binned output + provenance attrs (ref: bin_data.py:701-760)."""
        from gpsat_tpu_torch.data.ingest import get_run_info

        with TableStore(file) as store:
            store.append(table, df_bin)
            store.put_attrs(
                table,
                run_info=json_serializable(get_run_info()),
                **{k: json_serializable(v) for k, v in config_attrs.items()},
            )
        cprint(f"binned data written to {file}:{table}", c="OKGREEN")


def bin_obs_by_date(
    df: pd.DataFrame,
    val_col: str,
    date_col: str = "date",
    all_dates_in_range: bool = True,
    x_col: str = "x",
    y_col: str = "y",
    grid_res: float = None,
    date_col_format: str = "%Y%m%d",
    x_min: float = -4500000.0,
    x_max: float = 4500000.0,
    y_min: float = -4500000.0,
    y_max: float = 4500000.0,
    n_x: int = None,
    n_y: int = None,
    bin_statistic: str = "mean",
    verbose: bool = False,
):
    """Legacy per-date binning (ref: GPSat/utils.py:796-963): one [n_y, n_x]
    grid of ``bin_statistic`` per unique date string, NaN grids for dates
    with no data (when all_dates_in_range fills the calendar span).

    Returns (dict date -> 2-d array [y, x], x_edges, y_edges).
    """
    from scipy.stats import binned_statistic_2d

    if grid_res is None:
        assert n_x is not None and n_y is not None, "provide grid_res or both n_x and n_y"
    else:
        n_x = int((x_max - x_min) / (grid_res * 1000))
        n_y = int((y_max - y_min) / (grid_res * 1000))

    x_edge = np.linspace(x_min, x_max, n_x + 1)
    y_edge = np.linspace(y_min, y_max, n_y + 1)

    dates = np.sort(df[date_col].unique())
    if all_dates_in_range and len(dates):
        lo = pd.to_datetime(str(dates[0]), format=date_col_format)
        hi = pd.to_datetime(str(dates[-1]), format=date_col_format)
        dates = pd.date_range(lo, hi, freq="D").strftime(date_col_format).to_numpy()

    out = {}
    by_date = dict(tuple(df.groupby(df[date_col].astype(str))))
    for d in dates:
        sub = by_date.get(str(d))
        if sub is None or len(sub) == 0:
            if verbose:
                print(f"no data for {d}; NaN grid")
            out[d] = np.full((n_y, n_x), np.nan)
            continue
        stat, _, _, _ = binned_statistic_2d(
            sub[x_col].values, sub[y_col].values, sub[val_col].values,
            statistic=bin_statistic, bins=[x_edge, y_edge],
            range=[[x_min, x_max], [y_min, y_max]],
        )
        out[d] = stat.T  # [y, x] orientation, matching the reference
    return out, x_edge, y_edge
