"""Plotting utilities (ref: GPSat/plot_utils.py:38-756).

The port's copy of ``gpsat_tpu/plot_utils.py``. The reference plots on
cartopy polar-stereographic axes; without cartopy, map plots project
lon/lat through the package's own EASE2 (laea) projection
(``utils/projections.WGS84toEASE2``) and draw in projected meters. When
cartopy is importable the same entry points draw on GeoAxes.

matplotlib (and cartopy, seaborn) are imported inside the functions that
draw, never when the module is imported: the card's machine may lack
them, and ``bin_data`` re-exports ``plot_wrapper`` from here.
"""

from __future__ import annotations

import importlib.util
import warnings
from typing import List, Optional

import numpy as np
import pandas as pd

from gpsat_tpu_torch.utils.projections import WGS84toEASE2

HAS_CARTOPY = importlib.util.find_spec("cartopy") is not None


def _cartopy():
    """(cartopy.crs, cartopy.feature), imported at first use."""
    import cartopy.crs as ccrs
    import cartopy.feature as cfeat

    return ccrs, cfeat


def get_projection(projection=None):
    """Projection spec: cartopy CRS when available, otherwise a descriptor
    consumed by plot_pcolormesh's laea fallback (ref: plot_utils.py:181)."""
    if HAS_CARTOPY:
        ccrs, _ = _cartopy()
        if projection is None:
            return ccrs.NorthPolarStereo()
        if isinstance(projection, str):
            if projection.lower() == "north":
                return ccrs.NorthPolarStereo()
            if projection.lower() == "south":
                return ccrs.SouthPolarStereo()
            raise ValueError(f"projection: {projection} not understood")
        return projection
    if projection is None or (isinstance(projection, str) and projection.lower() == "north"):
        return {"laea_lat_0": 90}
    if isinstance(projection, str) and projection.lower() == "south":
        return {"laea_lat_0": -90}
    return projection


def _apply_quantile_clims(plot_data, vmin, vmax, qvmin, qvmax):
    if qvmin is not None:
        vmin = np.nanquantile(plot_data, q=qvmin)
    if qvmax is not None:
        vmax = np.nanquantile(plot_data, q=qvmax)
    if vmin is not None and vmax is not None:
        assert vmin <= vmax, f"vmin: {vmin} > vmax: {vmax}"
    return vmin, vmax


def plot_pcolormesh(
    ax,
    lon,
    lat,
    plot_data,
    fig=None,
    title=None,
    vmin=None,
    vmax=None,
    qvmin=None,
    qvmax=None,
    cmap="YlGnBu_r",
    cbar_label=None,
    scatter=False,
    extent=None,
    ocean_only=False,
    lat_0: float = 90,
    **scatter_args,
):
    """Polar map of gridded/scattered data (ref: plot_utils.py:38-114)."""
    lon = np.asarray(lon)
    lat = np.asarray(lat)
    plot_data = np.asarray(plot_data)
    if ocean_only:
        # mask land cells (ref: plot_utils.py:65-74, optional dependency)
        try:
            from global_land_mask import globe as globe_mask

            plot_data = np.where(globe_mask.is_ocean(lat, lon), plot_data, np.nan)
        except ImportError:
            warnings.warn("ocean_only=True but global-land-mask is not installed; plotting all cells")
    vmin, vmax = _apply_quantile_clims(plot_data, vmin, vmax, qvmin, qvmax)

    if HAS_CARTOPY:
        ccrs, cfeat = _cartopy()
        ax.coastlines(resolution="50m", color="white")
        ax.add_feature(cfeat.LAND, color=(0.8, 0.8, 0.8))
        extent = [-180, 180, 60, 90] if extent is None else extent
        ax.set_extent(extent, ccrs.PlateCarree())
        tr = dict(transform=ccrs.PlateCarree())
        X, Y = lon, lat
    else:
        X, Y = WGS84toEASE2(lon, lat, lat_0=lat_0)
        tr = {}
        ax.set_aspect("equal")

    if title:
        ax.set_title(title)
    if not scatter:
        s = ax.pcolormesh(X, Y, plot_data, cmap=cmap, vmin=vmin, vmax=vmax, shading="auto", rasterized=True, **tr)
    else:
        non_nan = ~np.isnan(plot_data)
        s = ax.scatter(
            np.asarray(X)[non_nan],
            np.asarray(Y)[non_nan],
            c=plot_data[non_nan],
            cmap=cmap,
            vmin=vmin,
            vmax=vmax,
            **tr,
            **scatter_args,
        )
    if fig is not None:
        cbar = fig.colorbar(s, ax=ax, orientation="horizontal", pad=0.03, fraction=0.03)
        if cbar_label:
            cbar.set_label(cbar_label, fontsize=14)
    return s


def plot_hist(
    ax,
    data,
    title="Histogram / Density",
    ylabel=None,
    xlabel=None,
    select_bool=None,
    stats_values=None,
    stats_loc=(0.2, 0.9),
    drop_nan_inf=True,
    q_vminmax=None,
    rasterized=False,
):
    """Histogram + optional stats overlay (ref: plot_utils.py:117-178)."""
    data = np.asarray(data).flatten()
    hist_data = data if select_bool is None else data[select_bool]
    if drop_nan_inf:
        hist_data = hist_data[np.isfinite(hist_data)]
    if q_vminmax is not None:
        assert len(q_vminmax) == 2, f"q_vminmax needs 2 entries, got: {len(q_vminmax)}"
        lo, hi = np.nanquantile(hist_data, q=list(q_vminmax))
        hist_data = hist_data[(hist_data >= lo) & (hist_data <= hi)]

    try:
        import seaborn as sns

        sns.histplot(data=hist_data, kde=True, ax=ax, rasterized=rasterized)
    except ImportError:
        ax.hist(hist_data, bins=60, density=True, rasterized=rasterized)
    if title:
        ax.set_title(title)
    if ylabel:
        ax.set_ylabel(ylabel)
    if xlabel:
        ax.set_xlabel(xlabel)
    if stats_values is not None:
        # the reference's stats box (ref: plot_utils.py:153-178): computed
        # on the FULL (untrimmed) data
        from scipy.stats import kurtosis, skew

        full = data[np.isfinite(data)] if drop_nan_inf else data
        stats = {
            "mean": np.mean(full), "std": np.std(full), "skew": skew(full),
            "kurtosis": kurtosis(full), "num obs": len(full),
            "max": np.max(full), "min": np.min(full),
        }
        stats_values = [stats_values] if isinstance(stats_values, str) else stats_values
        for sv in stats_values:
            assert sv in stats, f"stats_values: {sv} not in stats: {list(stats)}"
        txt = "\n".join(
            f"{k}: {stats[k]:.2f}" if isinstance(stats[k], (float, np.floating)) else f"{k}: {stats[k]}"
            for k in stats_values
        )
        ax.text(*stats_loc, txt, ha="center", va="center", transform=ax.transAxes)
    return ax


def plot_xy(ax, x, y, title=None, y_label=None, x_label=None, scatter=False, **kwargs):
    (ax.scatter if scatter else ax.plot)(x, y, **kwargs)
    if title:
        ax.set_title(title)
    if y_label:
        ax.set_ylabel(y_label)
    if x_label:
        ax.set_xlabel(x_label)
    return ax


# ---- results-file-driven plots (ref: plot_utils.py:224-345) ----

def _load_table(dfs, table, load_kwargs):
    """Table -> DataFrame through the loader, so load_kwargs (row_select,
    col_funcs, where, ...) behave exactly like the reference's
    DataLoader.load(dfs[table], **load_kwargs)."""
    from gpsat_tpu_torch.data.dataloader import load as dl_load

    if load_kwargs:
        return dl_load(dfs[table], **load_kwargs)
    return dfs[table]


def plot_xy_from_results_data(ax, dfs, table, x_col, y_col, load_kwargs=None, plot_kwargs=None, verbose=False, **kwargs):
    df = _load_table(dfs, table, load_kwargs)
    plot_kwargs = plot_kwargs or {}
    return plot_xy(ax, df[x_col].values, df[y_col].values, **plot_kwargs)


def plot_hist_from_results_data(ax, dfs, table, val_col, load_kwargs=None, plot_kwargs=None, verbose=False, **kwargs):
    df = _load_table(dfs, table, load_kwargs)
    plot_kwargs = plot_kwargs or {}
    return plot_hist(ax, df[val_col].values, **plot_kwargs)


def plot_pcolormesh_from_results_data(
    ax, dfs, table, val_col,
    lon_col=None, lat_col=None,
    x_col=None, y_col=None, lat_0=90, lon_0=0,
    fig=None, load_kwargs=None, plot_kwargs=None,
    weighted_values_kwargs=None, verbose=False, **kwargs,
):
    """Map plot from a results table (ref: plot_utils.py:273-345): gridded
    pcolormesh via dataframe_to_2d_array + EASE2->WGS84 when scatter=False,
    lon/lat scatter otherwise; optional distance-weighted combination of
    overlapping expert predictions first."""
    df = _load_table(dfs, table, load_kwargs)
    plot_kwargs = dict(plot_kwargs or {})
    for c in (x_col, y_col, lon_col, lat_col, val_col):
        if c is not None:
            assert c in df, f"'{c}' (column) not in plot data"

    if weighted_values_kwargs is not None:
        from gpsat_tpu_torch.utils.weights import get_weighted_values

        df = get_weighted_values(df=df, **weighted_values_kwargs)
        if load_kwargs and load_kwargs.get("col_funcs"):
            # get_weighted_values drops derived columns; re-apply
            from gpsat_tpu_torch.data.dataloader import add_cols

            add_cols(df, load_kwargs["col_funcs"])

    if not plot_kwargs.get("scatter", False):
        assert x_col is not None and y_col is not None, (
            f"2d-array plotting requires x_col: {x_col} and y_col: {y_col}"
        )
        from gpsat_tpu_torch.utils.projections import EASE2toWGS84
        from gpsat_tpu_torch.utils.tables import dataframe_to_2d_array

        val2d, x_grid, y_grid = dataframe_to_2d_array(df, x_col=x_col, y_col=y_col, val_col=val_col)
        # the axes come back 1-d; the projection needs the full (y, x) lattice
        x_2d, y_2d = np.meshgrid(x_grid, y_grid)
        lon_grid, lat_grid = EASE2toWGS84(x_2d, y_2d, lat_0=lat_0, lon_0=lon_0)
        return plot_pcolormesh(ax, lon_grid, lat_grid, val2d, fig=fig, **plot_kwargs)

    assert lon_col is not None and lat_col is not None, (
        f"scatter plotting requires lon_col: {lon_col} and lat_col: {lat_col}"
    )
    return plot_pcolormesh(ax, df[lon_col].values, df[lat_col].values, df[val_col].values, fig=fig, **plot_kwargs)


def plot_xy_heatmap_from_results_data(
    ax, dfs, table, val_col, x_col="x", y_col="y", fig=None, load_kwargs=None, plot_kwargs=None, verbose=False
):
    """Scatter val_col over already-projected (x, y) coordinates."""
    df = dfs[table]
    pk = dict(plot_kwargs or {})
    vmin, vmax = _apply_quantile_clims(df[val_col].values, pk.pop("vmin", None), pk.pop("vmax", None),
                                       pk.pop("qvmin", None), pk.pop("qvmax", None))
    title = pk.pop("title", None)
    s = ax.scatter(df[x_col].values, df[y_col].values, c=df[val_col].values, vmin=vmin, vmax=vmax, **pk)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    if fig is not None:
        fig.colorbar(s, ax=ax)
    return s


def plots_from_config(plot_configs, dfs, plots_per_row: int = 3, num_plots_row_col_size=None, suptitle: str = ""):
    """Grid of config-driven plots (ref: plot_utils.py:457-499)."""
    import matplotlib.pyplot as plt

    n = len(plot_configs)
    ncols = min(plots_per_row, max(n, 1))
    nrows = -(-n // ncols)
    fig, axs = plt.subplots(nrows, ncols, figsize=(5 * ncols, 4 * nrows), squeeze=False)
    if suptitle:
        fig.suptitle(suptitle)
    for i, pc in enumerate(plot_configs):
        ax = axs[i // ncols][i % ncols]
        ptype = pc.get("plot_type", "plot_xy")
        fn = {
            "plot_xy": plot_xy_from_results_data,
            "hist": plot_hist_from_results_data,
            "heatmap": plot_pcolormesh_from_results_data,
            "xy_heatmap": plot_xy_heatmap_from_results_data,
        }[ptype]
        kw = {k: v for k, v in pc.items() if k != "plot_type"}
        if ptype in ("heatmap", "xy_heatmap"):
            kw.setdefault("fig", fig)
        fn(ax, dfs, **kw)
    fig.tight_layout()
    return fig


def plot_hyper_parameters(
    dfs,
    coords_col: List[str],
    row_select=None,
    table_names=None,
    table_suffix: str = "",
    plot_template: Optional[dict] = None,
    plots_per_row: int = 3,
    suptitle: str = "hyper parameters",
    qvmin: float = 0.01,
    qvmax: float = 0.99,
):
    """Panel grid over hyperparameter tables (ref: plot_utils.py:501-606)."""
    if table_names is None:
        table_names = ["lengthscales", "kernel_variance", "likelihood_variance"]
    plot_configs = []
    for tn in table_names:
        table = f"{tn}{table_suffix}"
        if table not in dfs:
            continue
        df = dfs[table]
        dim_cols = [c for c in df.columns if c.startswith("_dim_")]
        combos = df[dim_cols].drop_duplicates() if dim_cols else pd.DataFrame([{}])
        for _, row in combos.iterrows():
            pc = dict(plot_template or {})
            pc.update(
                {
                    "plot_type": "xy_heatmap",
                    "table": table,
                    "val_col": tn,
                    "x_col": coords_col[0],
                    "y_col": coords_col[1],
                    "plot_kwargs": {"qvmin": qvmin, "qvmax": qvmax, "title": f"{table} {dict(row)}"},
                }
            )
            plot_configs.append(pc)
    return plots_from_config(plot_configs, dfs, plots_per_row=plots_per_row, suptitle=suptitle)


def plot_wrapper(
    plt_df,
    val_col,
    lon_col: str = "lon",
    lat_col: str = "lat",
    scatter_plot_size: int = 2,
    plt_where=None,
    projection=None,
    extent=None,
):
    """Two-panel data review: polar scatter + histogram (ref: plot_utils.py:608-756)."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 5))
    if HAS_CARTOPY:
        ax0 = fig.add_subplot(1, 2, 1, projection=get_projection(projection))
    else:
        ax0 = fig.add_subplot(1, 2, 1)
    ax1 = fig.add_subplot(1, 2, 2)
    plot_pcolormesh(
        ax0,
        plt_df[lon_col].values,
        plt_df[lat_col].values,
        plt_df[val_col].values,
        fig=fig,
        scatter=True,
        s=scatter_plot_size,
        extent=extent,
    )
    plot_hist(ax1, plt_df[val_col].values, xlabel=val_col)
    fig.tight_layout()
    return fig


def plot_gpflow_minimal_example(model, model_init=None, opt_params=None, pred_params=None):
    """Reference-named smoke harness (ref: GPSat/plot_utils.py:346-456):
    runs the gpflow getting-started example through any BaseGPRModel and
    returns (predictions dict, parameters dict) like the reference. The
    'gpflow' in the name refers to the example's origin, not the backend:
    ``model`` is any model class of the port (``model_init`` may carry
    ``device="cpu"``; the classes default to the card)."""
    pred, params, _ = plot_minimal_example(model, model_init=model_init, opt_params=opt_params,
                                           pred_params=pred_params)
    return pred, params


def plot_minimal_example(model_cls, model_init=None, opt_params=None, pred_params=None):
    """Run any BaseGPRModel through the gpflow getting-started example and
    plot fit +-1.96 sigma (ref: plot_utils.py:346 plot_gpflow_minimal_example;
    data from gpflow.github.io basic_usage).

    Returns (predictions dict, parameters dict, figure).
    """
    import matplotlib.pyplot as plt

    model_init = model_init or {}
    opt_params = opt_params or {}
    pred_params = pred_params or {}

    # the gpflow minimal-example dataset
    X = np.array([0.865, 0.666, 0.804, 0.771, 0.147, 0.866, 0.007, 0.026,
                  0.171, 0.889, 0.243, 0.028])[:, None]
    Y = np.array([1.57, 3.48, 3.12, 3.91, 3.07, 1.35, 3.80, 3.82, 3.49,
                  1.30, 4.00, 3.82])[:, None]

    model = model_cls(coords=X, obs=Y, **model_init)
    model.optimise_parameters(**opt_params)
    Xnew = np.linspace(-0.1, 1.1, 100)[:, None]
    pred = model.predict(coords=Xnew, apply_scale=False, **pred_params)
    params = model.get_parameters() if hasattr(model, "get_parameters") else {
        p: getattr(model, f"get_{p}")() for p in model.param_names
    }

    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(X[:, 0], Y[:, 0], "kx", label="observations")
    f, fv = np.asarray(pred["f*"]).ravel(), np.asarray(pred["f*_var"]).ravel()
    ax.plot(Xnew[:, 0], f, "C0", label="posterior mean")
    ax.fill_between(Xnew[:, 0], f - 1.96 * np.sqrt(fv), f + 1.96 * np.sqrt(fv),
                    color="C0", alpha=0.2, label="95% f*")
    ax.legend()
    ax.set_title(getattr(model_cls, "__name__", str(model_cls)))
    return pred, params, fig
