"""The port's data-preparation path against the JAX package's, on the CPU:
projections and datetime config funcs (gpsat_tpu_torch/utils/projections.py,
datetime_utils.py), the PyTables reader (data/pytables_compat.py) and its
four consumers, ingest and binning (data/ingest.py, data/binning.py) and
the read_and_store / bin_data commands. Everything here is numpy, pandas and
h5py on both sides: no JAX program is compiled."""

import json
import os
import pickle

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import gpsat_tpu.data.binning as JBIN
import gpsat_tpu.data.ingest as JING
import gpsat_tpu.datetime_utils as JDT
from gpsat_tpu import bin_data as jax_bin_data
from gpsat_tpu import read_and_store as jax_read_and_store
from gpsat_tpu.data import dataloader as JDL
from gpsat_tpu.data import pytables_compat as JPT
from gpsat_tpu.experts import LocalExpertOI as JOI
from gpsat_tpu.experts import get_results_from_h5file as jax_results
from gpsat_tpu.utils import projections as JP
from gpsat_tpu_torch import cli
from gpsat_tpu_torch import datetime_utils as TDT
from gpsat_tpu_torch.data import binning as TBIN
from gpsat_tpu_torch.data import dataloader as TDL
from gpsat_tpu_torch.data import ingest as TING
from gpsat_tpu_torch.data import pytables_compat as TPT
from gpsat_tpu_torch.data import store as TSTORE
from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.experts import LocalExpertOI as TOI
from gpsat_tpu_torch.experts import core_for, get_results_from_h5file as port_results, initial_cparams
from gpsat_tpu_torch.utils import config_func as TCF
from gpsat_tpu_torch.utils import projections as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# projections and datetime funcs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lat_0", [90, -90, 60])
def test_projections_match_jax(lat_0):
    # forward within 1e-9 m, inverse within 1e-12 degrees, both aspects and
    # an oblique one, every return_vals; the _New aliases are the same map
    rng = np.random.default_rng(lat_0 + 100)
    lon = rng.uniform(-180, 180, 500)
    lat = rng.uniform(50, 89.9, 500) * np.sign(lat_0)
    for rv in ("both", "x", "y"):
        got, want = TP.WGS84toEASE2(lon, lat, rv, lat_0=lat_0), JP.WGS84toEASE2(lon, lat, rv, lat_0=lat_0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9, err_msg=rv)
    x, y = JP.WGS84toEASE2(lon, lat, lat_0=lat_0)
    for rv in ("both", "lon", "lat"):
        got, want = TP.EASE2toWGS84(x, y, rv, lat_0=lat_0), JP.EASE2toWGS84(x, y, rv, lat_0=lat_0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=rv)
    np.testing.assert_allclose(TP.WGS84toEASE2_New(lon, lat, lat_0=lat_0), JP.WGS84toEASE2(lon, lat, lat_0=lat_0),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(TP.EASE2toWGS84_New(x, y, lat_0=lat_0), JP.EASE2toWGS84(x, y, lat_0=lat_0), rtol=0,
                               atol=1e-12)
    # the reference's documented value (pyproj), as the JAX package's docstring states it
    np.testing.assert_allclose(TP.WGS84toEASE2(-105.01621, 39.57422), (-5254767.015, 1409604.104), atol=1e-3)


def test_datetime_funcs_match_jax_and_resolve_in_a_config():
    # the five registered satellite-datetime funcs against the JAX package's,
    # each called through config_func as a config names it ("@name")
    df = pd.DataFrame({"t": [0.5, 1.25, 365.0], "ts": ["2020-03-01 10:11:12", "2020-03-02 00:00:00",
                                                       "2021-01-31 23:59:59"],
                       "yr": [2020, 2020, 2021], "mo": [3, 3, 1], "dy": [1, 2, 31], "hms": [101112, 0, 235959]})
    gpod = "S3A_GPOD_SAR__SRA_A__20191031T233355_20191101T002424_034_023_MAR.proc"
    saral = "SARAL_C139_0036_20200331_234125_20200401_003143_extra.nc"
    cases = [
        ("from_file_start_end_datetime_GPOD", dict(args=[gpod, df])),
        ("from_file_start_end_datetime_SARAL", dict(args=[saral, df])),
        ("datetime_from_float_column", dict(col_args="t", kwargs={"epoch": (2000, 1, 1)})),
        ("date_from_datetime", dict(col_args="ts")),
        ("datetime_from_ymd_cols", dict(col_args=["yr", "mo", "dy", "hms"])),
    ]
    for name, spec in cases:
        got = TCF.config_func(f"@{name}", df=df, **spec)
        want = getattr(JDT, name)(*([df[c].values for c in np.atleast_1d(spec.get("col_args", []))]
                                    + spec.get("args", [])), **spec.get("kwargs", {}))
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name
        assert TCF.REGISTERED_FUNCS[name] is getattr(TDT, name)
    # the projections resolve too, and a tuple key assigns both columns
    geo = pd.DataFrame({"lon": [10.0, -40.0], "lat": [80.0, 75.0]})
    TDL.add_cols(geo, {("x", "y"): {"func": "@WGS84toEASE2", "col_args": ["lon", "lat"]}})
    np.testing.assert_allclose(geo[["x", "y"]].to_numpy().T, JP.WGS84toEASE2(geo["lon"], geo["lat"]), atol=1e-9)
    back = TCF.config_func("@EASE2toWGS84", df=geo, col_args=["x", "y"])
    np.testing.assert_allclose(np.stack(back), geo[["lon", "lat"]].to_numpy().T, atol=1e-9)


# --------------------------------------------------------------------------
# the PyTables reader (the fixture writer is tests/test_pytables_compat.py's)
# --------------------------------------------------------------------------


def _write_frame_table(f, key, *, index_fields, blocks, data_columns=(), nrows=None):
    """Hand-write one pandas 'frame_table' group.

    index_fields: {name: (values, kind)}; blocks: [(field_name, colnames,
    2-d values[, dtype_str])] where dtype_str mirrors pandas's
    ``<field>_dtype`` attr (e.g. 'datetime64', 'string40', 'float64');
    data_columns: [(field_name, values, kind)].
    """
    grp = f.create_group(key)
    grp.attrs["pandas_type"] = np.bytes_(b"frame_table")
    grp.attrs["table_type"] = np.bytes_(b"appendable_frame")
    grp.attrs["encoding"] = np.bytes_(b"UTF-8")
    grp.attrs["index_cols"] = np.void(pickle.dumps([(0, n) for n in index_fields]))

    dtype = []
    for n, (vals, kind) in index_fields.items():
        dtype.append((n, vals.dtype))
    for fn, _, vals, *_ in blocks:
        dtype.append((fn, vals.dtype, (vals.shape[1],)))
    for fn, vals, _ in data_columns:
        dtype.append((fn, vals.dtype))
    n = nrows if nrows is not None else len(next(iter(index_fields.values()))[0])
    rec = np.zeros(n, dtype=dtype)
    for name, (vals, kind) in index_fields.items():
        rec[name] = vals
    for fn, _, vals, *_ in blocks:
        rec[fn] = vals
    for fn, vals, _ in data_columns:
        rec[fn] = vals
    ds = grp.create_dataset("table", data=rec)
    ds.attrs["CLASS"] = np.bytes_(b"TABLE")
    ds.attrs["NROWS"] = n
    j = 0
    for name, (vals, kind) in index_fields.items():
        ds.attrs[f"FIELD_{j}_NAME"] = np.bytes_(name.encode())
        ds.attrs[f"{name}_kind"] = np.bytes_(kind.encode())
        j += 1
    for fn, cols, _, *dt in blocks:
        ds.attrs[f"FIELD_{j}_NAME"] = np.bytes_(fn.encode())
        ds.attrs[f"{fn}_kind"] = np.void(pickle.dumps(list(cols)))
        if dt:
            ds.attrs[f"{fn}_dtype"] = np.bytes_(dt[0].encode())
        j += 1
    for fn, _, dtype_str in data_columns:
        ds.attrs[f"FIELD_{j}_NAME"] = np.bytes_(fn.encode())
        ds.attrs[f"{fn}_kind"] = np.void(pickle.dumps([fn]))
        ds.attrs[f"{fn}_dtype"] = np.bytes_(dtype_str.encode())
        j += 1


XS, YS = np.array([3.0, 7.0, 7.0]), np.array([3.0, 7.0, 3.0])
CFG = {"model": {"oi_model": "GPflowGPRModel"}}


@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    """A store shaped like the reference's outputs: an observations table
    (int index, float block, string and datetime data_columns, a string
    block), a results store's oi_config / run_details / expert_locs and
    one parameter table per GPR parameter, indexed by expert coordinates
    (the third expert's lengthscales NaN: not loaded)."""
    path = str(tmp_path_factory.mktemp("pytables") / "ref.h5")
    rng = np.random.default_rng(0)
    n = 12
    dates = np.array(["2020-03-04", "2020-03-05", "2020-03-06"] * 4, dtype="datetime64[ns]")
    with h5py.File(path, "w") as f:
        _write_frame_table(
            f, "data",
            index_fields={"index": (np.arange(n, dtype=np.int64), "integer")},
            blocks=[("values_block_0", ["x", "y", "obs"], rng.normal(size=(n, 3)), "float64"),
                    ("values_block_1", ["source"], np.array([[b"track"]] * n, dtype="S8"), "string8")],
            data_columns=[("sat", np.array([b"S3A", b"S3B"] * 6, dtype="S3"), "string"),
                          ("date", dates.view("int64"), "datetime64[ns]")],
        )
        _write_frame_table(
            f, "oi_config",
            index_fields={"index": (np.arange(1, dtype=np.int64), "integer")},
            data_columns=[("idx", np.array([1], dtype=np.int64), "integer"),
                          ("config", np.array([json.dumps(CFG).encode()], dtype="S200"), "string")],
            blocks=[],
        )
        coords = {"x": (XS, "float"), "y": (YS, "float")}
        _write_frame_table(f, "run_details", index_fields=coords,
                           blocks=[("values_block_0", ["num_obs", "objective_value"],
                                    np.array([[10.0, -5.0], [12.0, -6.0], [9.0, -4.0]]))])
        _write_frame_table(f, "expert_locs", index_fields=coords,
                           blocks=[("values_block_0", ["elev"], np.array([[3.0], [4.0], [5.0]]))])
        _write_frame_table(
            f, "lengthscales",
            index_fields={"x": (np.repeat(XS, 2), "float"), "y": (np.repeat(YS, 2), "float")},
            blocks=[("values_block_0", ["_dim_0", "lengthscales"],
                     np.stack([np.tile([0.0, 1.0], 3), [1.5, 2.5, 1.7, 2.7, np.nan, np.nan]], axis=1))],
        )
        for name, vals in (("kernel_variance", [0.8, 0.9, 1.1]), ("likelihood_variance", [0.01, 0.02, 0.03])):
            _write_frame_table(f, name, index_fields=coords,
                               blocks=[("values_block_0", ["_dim_0", name], np.stack([np.zeros(3), vals], axis=1))])
    return path


def test_pytables_reader_matches_jax(ref_store, tmp_path):
    # every table, with and without a where, and the tablestore engine of
    # load, equal to the JAX package's frames; one is_pytables_store
    assert TPT.is_pytables_store(ref_store) and not hasattr(TSTORE, "is_pytables_store")
    own = str(tmp_path / "own.h5")
    with TableStore(own) as s:
        s.append("t", pd.DataFrame({"a": [1.0]}))
    assert not TPT.is_pytables_store(own) and TPT.open_store(own).__class__ is TableStore
    assert TPT.list_tables(ref_store) == JPT.list_tables(ref_store)
    for t in TPT.list_tables(ref_store):
        pd.testing.assert_frame_equal(TPT.read_table(ref_store, t), JPT.read_table(ref_store, t))
    for where in ([{"col": "sat", "comp": "==", "val": "S3A"}], ["date >= '2020-03-05'"],
                  [{"col": "obs", "comp": ">", "val": 0.0}, {"col": "sat", "comp": "==", "val": "S3B"}]):
        got = TPT.read_table(ref_store, "data", where=where)
        pd.testing.assert_frame_equal(got, JPT.read_table(ref_store, "data", where=where))
        pd.testing.assert_frame_equal(TDL.load(ref_store, table="data", where=where),
                                      JDL.load(ref_store, table="data", where=where))
    pd.testing.assert_frame_equal(TDL.load(ref_store, table="lengthscales"), JDL.load(ref_store, table="lengthscales"))
    store = TPT.read_store(ref_store)
    assert sorted(store) == TPT.list_tables(ref_store)
    with TPT.open_store(ref_store) as s:
        assert "data" in s and "nope" not in s and s.keys() == TPT.list_tables(ref_store)
        pd.testing.assert_frame_equal(s.select("run_details"), JPT.read_table(ref_store, "run_details"))


def test_results_reading_from_pytables_matches_jax(ref_store):
    # get_results_from_h5file on a reference store: all tables, a
    # selection, the configs and the expert-location merge, as the JAX
    # package reads them
    for kw in ({}, {"select_tables": ["run_details"]}, {"merge_on_expert_locations": False}):
        got, got_cfg = port_results(ref_store, **kw)
        want, want_cfg = jax_results(ref_store, **kw)
        assert got_cfg == want_cfg == [CFG]
        assert sorted(got) == sorted(want), kw
        for k in want:
            pd.testing.assert_frame_equal(got[k], want[k], obj=f"{kw} {k}")


def _oi_config():
    rng = np.random.default_rng(1)
    obs = pd.DataFrame({"x": rng.uniform(0, 10, 200), "y": rng.uniform(0, 10, 200)})
    obs["obs"] = np.sin(obs["x"]) + 0.05 * rng.normal(size=200)
    return dict(
        expert_loc_config={"source": pd.DataFrame({"x": XS, "y": YS})},
        data_config={"data_source": obs, "obs_col": "obs", "coords_col": ["x", "y"],
                     "local_select": [{"col": ["x", "y"], "comp": "<", "val": 4.0}]},
        model_config={"oi_model": "GPflowGPRModel"},
        pred_loc_config={"method": "expert_loc"},
    )


def test_load_params_from_pytables_matches_jax_and_own_store(ref_store, tmp_path):
    # load_params at one location, as the JAX package's; and the sweep's
    # per-group loader gives the same arrays from the PyTables store as from
    # the same tables in the port's own store (NaN rows keep the init)
    class Model:
        param_names = ["lengthscales", "kernel_variance", "likelihood_variance"]

        def set_parameters(self, **kw):
            self.params = kw

    cfg = _oi_config()
    for loc in ({"x": 7.0, "y": 7.0}, {"x": 3.0, "y": 3.0}):
        want, got = Model(), Model()
        assert JOI(**cfg).load_params(want, file=ref_store, ref_loc=pd.DataFrame([loc])) == 0
        assert TOI(**cfg).load_params(got, file=ref_store, ref_loc=pd.DataFrame([loc])) == 0
        assert got.params.keys() == want.params.keys()
        for k in want.params:
            np.testing.assert_array_equal(got.params[k], want.params[k], err_msg=k)
    assert TOI(**cfg).load_params(Model(), file=ref_store, ref_loc=pd.DataFrame([{"x": 1.0, "y": 1.0}])) == 1

    own = str(tmp_path / "own_params.h5")
    with TableStore(own) as s:
        for name in Model.param_names:
            s.append(name, JPT.read_table(ref_store, name))
    toi = TOI(**{**cfg, "model_config": {"oi_model": "GPflowGPRModel", "load_params": {"file": ref_store}}})
    core = core_for(toi.model_init_params, toi.constraints)
    init = initial_cparams(core, toi.model_init_params, toi.constraints, 2)
    locs = pd.DataFrame({"x": XS, "y": YS})
    got = toi._load_params_for_experts(locs, ["x", "y"], init, core, ref_store)
    toi.model_load_params = {"file": own}
    want = toi._load_params_for_experts(locs, ["x", "y"], init, core, own)
    assert got.keys() == want.keys() == set(Model.param_names)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["lengthscales"][:2], [[1.5, 2.5], [1.7, 2.7]])
    assert np.isnan(got["lengthscales"][2]).all()


# --------------------------------------------------------------------------
# ingest, binning and the two commands
# --------------------------------------------------------------------------


def _write_tracks(root, days=("day1", "day2"), tracks=3, n=400, seed=0):
    """Synthetic along-track days in lon/lat (polar orbits' ground tracks
    over the Arctic), one CSV per track, with the projected x, y, an
    observation z, a datetime string and a YYYYMMDD date."""
    rng = np.random.default_rng(seed)
    for d, day in enumerate(days):
        os.makedirs(os.path.join(root, day), exist_ok=True)
        for t in range(tracks):
            lon0 = rng.uniform(-180, 180)
            lat = np.linspace(62.0, 88.0, n) + 0.01 * rng.normal(size=n)
            lon = lon0 + 40.0 * np.linspace(-1, 1, n) + 0.05 * rng.normal(size=n)
            x, y = JP.WGS84toEASE2(lon, lat)
            z = 0.3 * np.sin(x / 8e5) * np.cos(y / 6e5) + 0.05 * rng.normal(size=n)
            z[:: 97] = 9.0  # outliers the bin config's row_select drops
            times = pd.Timestamp(f"2020-03-0{d + 1}") + pd.to_timedelta(np.arange(n) + 3600 * t, unit="s")
            pd.DataFrame({"lon": lon, "lat": lat, "x": x, "y": y, "z": z,
                          "datetime": times.strftime("%Y-%m-%d %H:%M:%S"), "date": 20200301 + d}).to_csv(
                os.path.join(root, day, f"track_{t}.csv"), index=False)


def _tables(path):
    with TableStore(path, mode="r") as s:
        return {k: s.select(k, set_index=False) for k in s.keys()}, {k: s.get_attrs(k) for k in s.keys()}


def test_ingest_and_binning_match_jax(tmp_path):
    # read_and_store with the projection as a config func, then BinData in
    # both packages: the stored tables equal (the ledger's wall-clock
    # column aside); bin_wrapper's means against a plain numpy group-by
    # mean (1e-12); bin_data_by in 1-d, bin_obs_by_date and the legacy
    # readers against the JAX package's
    raw = str(tmp_path / "raw")
    _write_tracks(raw)
    col_funcs = {"datetime": {"func": "@to_datetime", "col_args": "datetime"},
                 "('px', 'py')": {"func": "@WGS84toEASE2", "col_args": ["lon", "lat"]}}
    outs = {}
    for tag, ing, binning in (("port", TING, TBIN), ("jax", JING, JBIN)):
        obs = str(tmp_path / f"{tag}_obs.h5")
        funcs = {(tuple(json.loads(k.replace("'", '"').replace("(", "[").replace(")", "]")))
                  if k.startswith("(") else k): v for k, v in col_funcs.items()}
        ing.read_and_store({"file": obs, "table": "data"}, raw, r"track_\d+\.csv", sub_dirs=["day1", "day2"],
                           col_funcs=funcs)
        binned = str(tmp_path / f"{tag}_binned.h5")
        binning.BinData().bin_data(
            input={"source": obs, "table": "data", "row_select": [{"col": "z", "comp": "<=", "val": 5.0}]},
            bin_config={"by_cols": "date", "val_col": "z", "x_col": "px", "y_col": "py", "grid_res": 50_000,
                        "bin_statistic": ["mean", "count"]},
            output={"file": binned, "table": "data"})
        outs[tag] = (_tables(obs), _tables(binned))
    for (got, got_attrs), (want, want_attrs) in zip(outs["port"], outs["jax"]):
        assert sorted(got) == sorted(want)
        for k in want:
            drop = ["when"] if k.startswith("_") else []
            pd.testing.assert_frame_equal(got[k].drop(columns=drop), want[k].drop(columns=drop), obj=k)
            # the provenance attrs name each package's own input file
            same = {a: v for a, v in got_attrs[k].items() if a != "run_info"}
            assert json.dumps(same).replace("port_obs", "jax_obs") == json.dumps(
                {a: v for a, v in want_attrs[k].items() if a != "run_info"}), k
    obs = outs["port"][0][0]["data"]
    np.testing.assert_allclose(obs["px"], obs["x"], rtol=0, atol=1e-6)

    keep = obs[obs["z"] <= 5.0]
    df_bin, stats = TBIN.BinData.bin_wrapper(keep.copy(), print_stats=False, by_cols="date", val_col="z",
                                             x_col="x", y_col="y", grid_res=50_000)
    df_bin = df_bin.dropna().reset_index()
    edges = np.linspace(-4.5e6, 4.5e6, 181)
    ix = np.clip(np.searchsorted(edges, keep["x"], side="right") - 1, 0, 179)
    iy = np.clip(np.searchsorted(edges, keep["y"], side="right") - 1, 0, 179)
    plain = keep.assign(ix=ix, iy=iy).groupby(["date", "iy", "ix"])["z"].mean()
    centres = (edges[:-1] + edges[1:]) / 2
    got = df_bin.set_index(["date", np.searchsorted(centres, df_bin["y"]), np.searchsorted(centres, df_bin["x"])])
    np.testing.assert_allclose(got["z"].sort_index().to_numpy(), plain.sort_index().to_numpy(), rtol=0, atol=1e-12)
    want_bin, want_stats = JBIN.BinData.bin_wrapper(keep.copy(), print_stats=False, by_cols="date", val_col="z",
                                                    x_col="x", y_col="y", grid_res=50_000)
    pd.testing.assert_frame_equal(stats, want_stats)

    for fn in ("bin_data_by",):
        kw = dict(by_cols="date", val_col="z", x_col="x", grid_res=100_000, bin_2d=False)
        pd.testing.assert_frame_equal(getattr(TBIN, fn)(keep.copy(), **kw), getattr(JBIN, fn)(keep.copy(), **kw))
    got_g, gx, gy = TBIN.bin_obs_by_date(keep.astype({"date": str}), "z", grid_res=100)
    want_g, wx, wy = JBIN.bin_obs_by_date(keep.astype({"date": str}), "z", grid_res=100)
    assert list(got_g) == list(want_g)
    for d in want_g:
        np.testing.assert_array_equal(got_g[d], want_g[d])
    np.testing.assert_array_equal(gx, wx)

    np.save(tmp_path / "a.npy", np.arange(12.0).reshape(3, 4))
    pd.testing.assert_frame_equal(TING.read_from_npy({"a": str(tmp_path / "a.npy")}),
                                  JING.read_from_npy({"a": str(tmp_path / "a.npy")}))
    with open(tmp_path / "p.pkl", "wb") as fh:
        pickle.dump({"S3A": np.arange(6.0).reshape(2, 3)}, fh)
    pd.testing.assert_frame_equal(TING.read_from_pkl_dict(str(tmp_path / "p.pkl")),
                                  JING.read_from_pkl_dict(str(tmp_path / "p.pkl")))
    assert TING.get_dirs_to_search(raw, walk=True) == JING.get_dirs_to_search(raw, walk=True)
    assert TING.get_run_info().keys() == JING.get_run_info().keys()
    pd.testing.assert_frame_equal(TING.read_flat_files(raw, r"track_0\.csv", sub_dirs=["day1"]),
                                  JING.read_flat_files(raw, r"track_0\.csv", sub_dirs=["day1"]))
    # the .nc branch: a track written as netCDF4 reads into the same frame
    # in both packages
    from gpsat_tpu.data.netcdf import write_netcdf

    write_netcdf(os.path.join(raw, "day1", "track_0.nc"), pd.read_csv(os.path.join(raw, "day1", "track_0.csv")))
    got_nc = TING.read_from_multiple_files(raw, r"track_0\.nc", read_engine="nc", sub_dirs=["day1"])
    pd.testing.assert_frame_equal(got_nc, JING.read_from_multiple_files(raw, r"track_0\.nc", read_engine="nc",
                                                                        sub_dirs=["day1"]))
    pd.testing.assert_frame_equal(got_nc.drop(columns="index"), pd.read_csv(os.path.join(raw, "day1", "track_0.csv")),
                                  check_dtype=False, check_like=True)  # netCDF keeps variables by name


def test_cli_commands_match_jax(tmp_path, monkeypatch):
    # python -m gpsat_tpu_torch.cli read_and_store / bin_data on temp-path
    # copies of the example configs, against the JAX package's mains on the
    # same configs: equal tables; a re-run skips the ingested batches; a
    # config holding "plot" bins as in the JAX package
    raw = str(tmp_path / "raw")
    _write_tracks(raw, seed=1)
    with open(os.path.join(ROOT, "configs", "example_read_and_store_raw_data.json")) as f:
        ras = json.load(f)
    with open(os.path.join(ROOT, "configs", "example_bin_raw_data.json")) as f:
        binc = json.load(f)
    outs = {}
    for tag in ("port", "jax"):
        r = {**ras, "file_dirs": raw, "output": {**ras["output"], "file": str(tmp_path / f"{tag}_obs.h5")}}
        b = {**binc, "input": {**binc["input"], "source": r["output"]["file"]},
             "output": {**binc["output"], "file": str(tmp_path / f"{tag}_binned.h5")}}
        if tag == "port":
            for name, cfg in (("read_and_store", r), ("bin_data", b)):
                path = tmp_path / f"{name}.json"
                path.write_text(json.dumps(cfg))
                monkeypatch.setattr("sys.argv", ["gpsat_tpu_torch.cli"])
                assert cli.main([name, str(path)]) == 0
            rows = len(_tables(r["output"]["file"])[0]["data"])
            assert cli.main(["read_and_store", str(tmp_path / "read_and_store.json")]) == 0  # resumable
            assert len(_tables(r["output"]["file"])[0]["data"]) == rows
        else:
            jax_read_and_store.main(r)
            jax_bin_data.main(b)
        outs[tag] = (_tables(r["output"]["file"])[0], _tables(b["output"]["file"])[0])
    for got, want in zip(outs["port"], outs["jax"]):
        assert sorted(got) == sorted(want)
        for k in want:
            drop = ["when"] if k.startswith("_") else []
            pd.testing.assert_frame_equal(got[k].drop(columns=drop), want[k].drop(columns=drop), obj=k)
    assert len(outs["port"][1]["data"]) > 0
    from gpsat_tpu_torch import bin_data as port_bin_data

    # a config that asks for the reference's plots bins as the JAX main bins
    # it: neither main reads the key
    binned = {}
    for tag, main in (("port", port_bin_data.main), ("jax", jax_bin_data.main)):
        cfg = {**binc, "plot": True, "input": {**binc["input"], "source": str(tmp_path / "port_obs.h5")},
               "output": {**binc["output"], "file": str(tmp_path / f"{tag}_plot_binned.h5")}}
        main(cfg)
        binned[tag] = _tables(cfg["output"]["file"])[0]
    assert sorted(binned["port"]) == sorted(binned["jax"]) and len(binned["port"]["data"]) > 0
    for k in binned["jax"]:
        drop = ["when"] if k.startswith("_") else []
        pd.testing.assert_frame_equal(binned["port"][k].drop(columns=drop), binned["jax"][k].drop(columns=drop), obj=k)
