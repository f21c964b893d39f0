"""The port's plotting utilities (gpsat_tpu_torch/plot_utils.py) against
the JAX package's (gpsat_tpu/plot_utils.py) on the Agg backend, without
cartopy: each port function draws the same figure data as its JAX
counterpart on the same frames (the arrays drawn, titles, labels, panel
counts, colour limits), as tests/test_plot_utils.py drives the JAX
package. ``LocalExpertOI.plot_locations_and_obs`` runs on a tiny OI config
in both packages. Host code only: no JAX program is compiled."""

import subprocess
import sys
from pathlib import Path

import matplotlib
import matplotlib.figure

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gpsat_tpu import plot_utils as JPU  # noqa: E402
from gpsat_tpu.experts import LocalExpertOI as JOI  # noqa: E402
from gpsat_tpu_torch import plot_utils as TPU  # noqa: E402
from gpsat_tpu_torch.experts import LocalExpertOI as TOI  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def dfs():
    rng = np.random.default_rng(0)
    n = 200
    preds = pd.DataFrame({
        "x": rng.uniform(-1e6, 1e6, n),
        "y": rng.uniform(-1e6, 1e6, n),
        "lon": rng.uniform(-180, 180, n),
        "lat": rng.uniform(60, 89, n),
        "f*": rng.normal(size=n),
        "_dim_0": np.zeros(n, dtype=int),
    })
    ls = preds[["x", "y"]].copy()
    ls["_dim_0"] = 0
    ls["lengthscales"] = rng.uniform(0.5, 2.0, n)
    return {"preds": preds, "lengthscales": ls}


def _array(a):
    a = np.ma.getdata(a) if a is not None else None
    return None if a is None else np.asarray(a, dtype=float)


def figure_data(fig):
    """What a figure draws, axes by axes: title, labels, and each
    collection's offsets, colour array and colour limits, each line's
    points, each bar's height, each text."""
    out = {"suptitle": fig._suptitle.get_text() if fig._suptitle else None, "axes": []}
    for ax in fig.axes:
        out["axes"].append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "collections": [(_array(c.get_offsets()), _array(c.get_array()), c.get_clim()) for c in ax.collections],
            "lines": [_array(line.get_xydata()) for line in ax.lines],
            "bars": [p.get_height() for p in ax.patches],
            "texts": [t.get_text() for t in ax.texts],
        })
    return out


def assert_same_figure(got, want, rtol=0.0):
    assert got["suptitle"] == want["suptitle"] and len(got["axes"]) == len(want["axes"])
    for a, b in zip(got["axes"], want["axes"]):
        assert (a["title"], a["xlabel"], a["ylabel"], a["texts"]) == (b["title"], b["xlabel"], b["ylabel"], b["texts"])
        assert len(a["collections"]) == len(b["collections"]) and len(a["lines"]) == len(b["lines"])
        for (off_a, arr_a, clim_a), (off_b, arr_b, clim_b) in zip(a["collections"], b["collections"]):
            for x, y in ((off_a, off_b), (arr_a, arr_b)):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_allclose(x, y, rtol=rtol, atol=0)
            np.testing.assert_allclose(np.array(clim_a, dtype=float), np.array(clim_b, dtype=float), rtol=rtol)
        for x, y in zip(a["lines"], b["lines"]):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-12 if rtol else 0)
        np.testing.assert_allclose(a["bars"], b["bars"], rtol=rtol)


def _both(draw):
    """draw(PU, fig, ax) for each package (a function that makes its own
    figure returns it); the data of each package's figure."""
    out = []
    for PU in (TPU, JPU):
        fig, ax = plt.subplots()
        drawn = draw(PU, fig, ax)
        out.append(figure_data(drawn if isinstance(drawn, matplotlib.figure.Figure) else fig))
        plt.close("all")
    return out


def test_plot_pcolormesh_scatter(dfs):
    p = dfs["preds"]
    got, want = _both(lambda PU, fig, ax: PU.plot_pcolormesh(ax, p["lon"], p["lat"], p["f*"].values, fig=fig,
                                                             scatter=True, qvmin=0.01, qvmax=0.99, title="f*"))
    assert len(got["axes"]) == 2 and got["axes"][0]["title"] == "f*"  # the map and its colour bar
    assert got["axes"][0]["collections"][0][2] == tuple(np.nanquantile(p["f*"].values, [0.01, 0.99]))
    assert_same_figure(got, want)


def test_plot_hist_with_stats(dfs):
    got, want = _both(lambda PU, fig, ax: PU.plot_hist(ax, dfs["preds"]["f*"].values, stats_values=["mean", "std"],
                                                       xlabel="f*", q_vminmax=(0.05, 0.95)))
    assert got["axes"][0]["texts"][0].startswith("mean: ") and got["axes"][0]["bars"]
    assert_same_figure(got, want)


def test_plot_xy(dfs):
    p = dfs["preds"]
    got, want = _both(lambda PU, fig, ax: PU.plot_xy(ax, p["x"].values, p["y"].values, title="xy", x_label="x",
                                                     y_label="y", scatter=True))
    assert_same_figure(got, want)


def test_plots_from_config_grid(dfs):
    configs = [
        {"plot_type": "hist", "table": "preds", "val_col": "f*"},
        {"plot_type": "xy_heatmap", "table": "preds", "val_col": "f*", "plot_kwargs": {"title": "xy"}},
        {"plot_type": "heatmap", "table": "preds", "val_col": "f*", "lon_col": "lon", "lat_col": "lat",
         "plot_kwargs": {"scatter": True}},
        {"plot_type": "heatmap", "table": "preds", "val_col": "f*", "x_col": "x", "y_col": "y"},
        {"plot_type": "plot_xy", "table": "preds", "x_col": "x", "y_col": "f*",
         "load_kwargs": {"row_select": [{"col": "f*", "comp": ">=", "val": 0.0}]}},
    ]
    got, want = _both(lambda PU, fig, ax: PU.plots_from_config(configs, dfs, suptitle="grid"))
    assert got["suptitle"] == "grid" and len(got["axes"]) >= 6  # 5 panels of a 2 x 3 grid, 3 colour bars
    assert_same_figure(got, want)


def test_plot_hyper_parameters(dfs):
    got, want = _both(lambda PU, fig, ax: PU.plot_hyper_parameters(dfs, coords_col=["x", "y"],
                                                                   table_names=["lengthscales", "kernel_variance"]))
    assert got["axes"][0]["title"].startswith("lengthscales")
    assert_same_figure(got, want)


def test_plot_wrapper(dfs):
    got, want = _both(lambda PU, fig, ax: PU.plot_wrapper(dfs["preds"], val_col="f*"))
    assert got["axes"][1]["xlabel"] == "f*"
    assert_same_figure(got, want)


def test_results_plots_respect_load_kwargs_and_weights(dfs):
    dfp = dfs["preds"].copy()
    dfp["ex"] = dfp["x"] + 0.1
    dfp["ey"] = dfp["y"]
    load = {"row_select": [{"col": "f*", "comp": ">=", "val": float(dfp["f*"].median())}]}
    got, want = _both(lambda PU, fig, ax: PU.plot_pcolormesh_from_results_data(
        ax, {"preds": dfp}, "preds", "f*", lon_col="lon", lat_col="lat", fig=fig, load_kwargs=load,
        plot_kwargs={"scatter": True}))
    assert len(got["axes"][0]["collections"][0][0]) == int((dfp["f*"] >= dfp["f*"].median()).sum())
    assert_same_figure(got, want)
    got, want = _both(lambda PU, fig, ax: PU.plot_xy_heatmap_from_results_data(
        ax, {"preds": dfp}, "preds", "f*", x_col="x", y_col="y", fig=fig))
    assert_same_figure(got, want)


def test_gridded_pcolormesh_non_square_grid():
    nx, ny = 7, 5
    x2d, y2d = np.meshgrid(np.linspace(-1e6, 1e6, nx), np.linspace(-5e5, 5e5, ny))
    df = pd.DataFrame({"x": x2d.ravel(), "y": y2d.ravel(),
                       "f*": np.random.default_rng(1).normal(size=nx * ny)})
    got, want = _both(lambda PU, fig, ax: PU.plot_pcolormesh_from_results_data(
        ax, {"preds": df}, "preds", "f*", x_col="x", y_col="y", fig=fig))
    assert got["axes"][0]["collections"][0][1].size == nx * ny
    assert_same_figure(got, want)


def test_get_projection_fallback():
    assert TPU.HAS_CARTOPY == JPU.HAS_CARTOPY
    for name in (None, "north", "south"):
        assert TPU.get_projection(name) == JPU.get_projection(name)


def test_plot_minimal_example():
    # the port's model class through both packages' plotting harness (the
    # JAX function takes any model class): the same fit, so the same figure
    # bit for bit; the class itself is held to the JAX one in
    # tests/test_torch_models.py
    from gpsat_tpu_torch.models import get_model

    model = get_model("GPflowGPRModel")
    kw = dict(model_init={"device": "cpu"}, opt_params={"max_iter": 100})
    t_pred, t_params, t_fig = TPU.plot_minimal_example(model, **kw)
    j_pred, j_params, j_fig = JPU.plot_minimal_example(model, **kw)
    assert np.isfinite(t_pred["f*"]).all() and "lengthscales" in t_params
    assert_same_figure(figure_data(t_fig), figure_data(j_fig))
    assert t_fig.axes[0].get_title() == "GPRModel" and len(t_fig.axes[0].lines) == 2
    pred, params = TPU.plot_gpflow_minimal_example(model, **kw)
    np.testing.assert_array_equal(pred["f*"], t_pred["f*"])
    plt.close("all")


def test_plot_locations_and_obs_matches_jax(tmp_path):
    # a tiny OI config (tests/test_torch_oi.py's field and 2 x 2 experts):
    # one panel per expert, each with the observations its local select
    # keeps and the expert's cross, in both packages
    rng = np.random.default_rng(11)
    n = 300
    obs = pd.DataFrame({"x": rng.uniform(0, 10, n), "y": rng.uniform(0, 10, n)})
    obs["obs"] = np.sin(obs["x"]) * np.cos(obs["y"])
    experts = pd.DataFrame({"x": [3.0, 3.0, 7.0, 7.0], "y": [3.0, 7.0, 3.0, 7.0]})
    local_select = [{"col": ["x", "y"], "comp": "<", "val": 2.5}]
    figs = []
    for OI in (TOI, JOI):
        oi = OI(expert_loc_config={"source": experts},
                data_config={"data_source": obs, "obs_col": "obs", "coords_col": ["x", "y"],
                             "local_select": local_select},
                model_config={"oi_model": "GPflowGPRModel"})
        image = tmp_path / f"{OI.__module__}.png"
        figs.append(figure_data(oi.plot_locations_and_obs(image_file=str(image), max_plots=3)))
        assert image.exists()
        plt.close("all")
    got, want = figs
    assert len(got["axes"]) == 3
    for i, ax in enumerate(got["axes"]):
        near = np.hypot(obs["x"] - experts["x"][i], obs["y"] - experts["y"][i]) < 2.5
        assert ax["title"] == f"expert {i}: n={int(near.sum())}"
        np.testing.assert_array_equal(ax["collections"][0][0], obs.loc[near, ["x", "y"]].values)
    assert_same_figure(got, want)


def test_bin_data_imports_no_matplotlib():
    # the card's machine may lack matplotlib: bin_data re-exports
    # plot_wrapper through a module __getattr__, and plot_utils imports
    # matplotlib only when it draws
    code = ("import sys; import gpsat_tpu_torch.bin_data as b, gpsat_tpu_torch.plot_utils; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'; "
            "assert b.plot_wrapper is gpsat_tpu_torch.plot_utils.plot_wrapper")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
