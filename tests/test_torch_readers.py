"""The port's readers against the JAX package's, on the CPU: zarr v2 stores
(every codec, blosc with both shuffles through the C++ and the Python
decoders) and netCDF4 files written by each package and read by the other,
the dataloader's parquet, netCDF and zarr engines, ingest's .nc branch,
the DataLoader facade, and the import of the port with h5py, pyarrow and
zstandard missing. Host code only: no JAX program is compiled."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.data import dataloader as JDL
from gpsat_tpu.data import ingest as JING
from gpsat_tpu.data import netcdf as JNC
from gpsat_tpu.data import zarr_reader as JZ
from gpsat_tpu.dataloader import DataLoader as JDataLoader
from gpsat_tpu_torch.data import dataloader as TDL
from gpsat_tpu_torch.data import ingest as TING
from gpsat_tpu_torch.data import netcdf as TNC
from gpsat_tpu_torch.data import zarr_reader as TZ
from gpsat_tpu_torch.dataloader import DataLoader as TDataLoader

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gridded_vars(seed=0):
    """An xarray-style group: a (time, y, x) field, a (y, x) mask, float,
    int and datetime coordinates."""
    rng = np.random.default_rng(seed)
    t = np.array(["2020-03-01", "2020-03-02", "2020-03-04"], dtype="datetime64[ns]")
    y = np.linspace(-1e5, 1e5, 7)
    x = np.arange(11, dtype=np.int64) * 25_000
    field = np.round(rng.normal(size=(3, 7, 11)), 3)
    field[1, 2, 3] = np.nan
    mask = rng.uniform(size=(7, 11)) > 0.3
    return {"obs": (("time", "y", "x"), field), "mask": (("y", "x"), mask)}, {"time": t, "y": y, "x": x}


def track_frame(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"x": rng.uniform(-5e5, 5e5, n), "y": rng.uniform(-5e5, 5e5, n),
                         "obs": rng.normal(size=n), "track": np.repeat(np.arange(6), n // 6),
                         "t": pd.Timestamp("2020-03-01") + pd.to_timedelta(np.arange(n), unit="min")})


@pytest.mark.parametrize("compress", [False, "zlib", "zstd", "blosc"])
def test_zarr_stores_read_across_packages(compress, tmp_path):
    # a store written by each package's writer reads into the same frame in
    # both packages (the port's blosc chunks through the C++ loops and the
    # pure-Python decoders alike)
    data_vars, coords = gridded_vars()
    JZ.write_zarr(str(tmp_path / "jax.zarr"), data_vars, coords=coords, compress=compress)
    TZ.write_zarr(str(tmp_path / "port.zarr"), data_vars, coords=coords, compress=compress)
    want = JZ.read_zarr(str(tmp_path / "jax.zarr"))
    assert len(want) == 3 * 7 * 11
    for store in ("jax.zarr", "port.zarr"):
        path = str(tmp_path / store)
        pd.testing.assert_frame_equal(TZ.read_zarr(path), want)
        pd.testing.assert_frame_equal(TZ.read_zarr(path, decoder="python"), want)
        pd.testing.assert_frame_equal(JZ.read_zarr(path), want)
        pd.testing.assert_frame_equal(TZ.read_zarr(path, variables=["mask"]), JZ.read_zarr(path, variables=["mask"]))


@pytest.mark.parametrize("shuffle", [0, 2])
def test_zarr_blosc_shuffles_and_chunks(shuffle, tmp_path):
    # unshuffled and bit-shuffled blosc chunks, ragged edge chunks: the port
    # reads its own store and the JAX reader reads it too
    df = track_frame(seed=shuffle)
    dv = {c: (("index",), df[c].to_numpy()) for c in ("x", "y", "obs", "track")}
    path = str(tmp_path / "s.zarr")
    TZ.write_zarr(path, dv, coords={"index": np.arange(len(df))}, compress="blosc", shuffle=shuffle, chunks=(64,))
    assert len([f for f in os.listdir(os.path.join(path, "x")) if not f.startswith(".")]) == 5
    got = TZ.read_zarr(path).reset_index()
    pd.testing.assert_frame_equal(got, JZ.read_zarr(path).reset_index())
    pd.testing.assert_frame_equal(got.drop(columns="index"), df[["obs", "track", "x", "y"]])


def test_netcdf_files_read_across_packages(tmp_path):
    # files written by each package read into the same frame in both: a
    # gridded dataset with a datetime coordinate, and a flat frame with a
    # string and a datetime column
    data_vars, coords = gridded_vars(seed=1)
    flat = track_frame(seed=1).assign(name=lambda d: [f"s{i % 3}" for i in range(len(d))])
    for tag, writer in (("jax", JNC.write_netcdf), ("port", TNC.write_netcdf)):
        writer(str(tmp_path / f"{tag}_grid.nc"), data_vars, coords=coords)
        writer(str(tmp_path / f"{tag}_flat.nc"), flat)
    for name in ("grid", "flat"):
        want = JNC.read_netcdf(str(tmp_path / f"jax_{name}.nc"))
        for tag in ("jax", "port"):
            path = str(tmp_path / f"{tag}_{name}.nc")
            pd.testing.assert_frame_equal(TNC.read_netcdf(path), want)
            pd.testing.assert_frame_equal(JNC.read_netcdf(path), want)
    pd.testing.assert_frame_equal(TNC.read_netcdf(str(tmp_path / "port_grid.nc"), variables=["obs"]),
                                  JNC.read_netcdf(str(tmp_path / "port_grid.nc"), variables=["obs"]))


@pytest.mark.parametrize("engine", ["parquet", "netcdf4", "zarr", "zarr_blosc"])
def test_dataloader_engines_match_jax_load(engine, tmp_path):
    # load() through each new engine, with a where pushdown, col_funcs,
    # row_select and col_select, against the JAX package's load
    df = track_frame(seed=2)
    if engine == "parquet":
        source = str(tmp_path / "d.parquet")
        df.to_parquet(source)
    elif engine == "netcdf4":
        source = str(tmp_path / "d.nc")
        JNC.write_netcdf(source, df)
    else:
        source = str(tmp_path / "d.zarr")
        JZ.write_zarr(source, {c: (("index",), df[c].to_numpy()) for c in df.columns},
                      coords={"index": np.arange(len(df))}, compress="blosc" if engine == "zarr_blosc" else True)
    kw = dict(source=source, where=[{"col": "track", "comp": ">=", "val": 2}],
              col_funcs={"r": {"source": "numpy", "func": "sqrt", "col_args": "obs"}},
              row_select=[{"col": "obs", "comp": ">", "val": -1.0}], reset_index=True)
    got = TDL.load(**kw)
    want = JDL.load(**kw)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) > 0 and (got["track"] >= 2).all()
    pd.testing.assert_frame_equal(TDL.load(source=source, col_select=["x", "y"]),
                                  JDL.load(source=source, col_select=["x", "y"]))


def test_parquet_filter_and_add_data_to_col_match_jax():
    where = [{"col": "a", "comp": ">=", "val": 1}, {"col": "b", "comp": "==", "val": 2, "negate": True},
             {"func": "lambda x: x > 0", "col_args": "a"}]
    assert TDL._wheres_to_parquet_filter(where) == JDL._wheres_to_parquet_filter(where) == [("a", ">=", 1)]
    assert TDL._wheres_to_parquet_filter(None) is JDL._wheres_to_parquet_filter(None) is None
    df = pd.DataFrame({"x": [1.0, 2.0], "y": [3, 4]})
    for spec in ({"date": ["2020-03-01", "2020-03-02"]}, {"k": 7}, None):
        pd.testing.assert_frame_equal(TDL.add_data_to_col(df, spec), JDL.add_data_to_col(df, spec))


def test_ingest_nc_branch_and_facade_match_jax(tmp_path):
    # ingest's .nc branch over a directory of netCDF tracks, and the
    # DataLoader facade's readers and store helpers, in both packages
    raw = tmp_path / "raw" / "day1"
    raw.mkdir(parents=True)
    for i in range(3):
        JNC.write_netcdf(str(raw / f"track_{i}.nc"), track_frame(seed=10 + i, n=60))
    kw = dict(file_regex=r"track_\d\.nc", read_engine="nc", sub_dirs=["day1"],
              row_select=[{"col": "obs", "comp": "<", "val": 1.0}])
    got = TING.read_from_multiple_files(str(tmp_path / "raw"), **kw)
    pd.testing.assert_frame_equal(got, JING.read_from_multiple_files(str(tmp_path / "raw"), **kw))
    assert len(got) > 100 and "index" in got.columns

    nc = str(raw / "track_0.nc")
    pd.testing.assert_frame_equal(TDataLoader.load(source=nc), JDataLoader.load(source=nc))
    assert TDataLoader.file_suffix_engine_map == JDataLoader.file_suffix_engine_map
    for name in ("load", "add_cols", "add_data_to_col", "data_select", "row_select_bool", "local_data_select",
                 "get_where_list", "get_where_list_legacy", "kdt_tree_list_for_local_select",
                 "read_from_multiple_files", "generate_local_expert_locations", "bin_data_by", "write_to_netcdf",
                 "get_attribute_from_table", "connect_to_hdf_store", "make_multiindex_df"):
        assert callable(getattr(TDataLoader, name)), name
    out = str(tmp_path / "facade.nc")
    TDataLoader.write_to_netcdf(track_frame(seed=3, n=30), out)
    pd.testing.assert_frame_equal(TNC.read_netcdf(out), JNC.read_netcdf(out))


def test_port_imports_without_h5py_pyarrow_zstandard():
    # the card's machine has no h5py and may lack pyarrow and zstandard:
    # the package and this slice's modules import without them, and a zarr
    # store with blosc chunks still loads
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('h5py', 'pyarrow', 'zstandard', 'tables'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import gpsat_tpu_torch, gpsat_tpu_torch.native, gpsat_tpu_torch.build_native\n"
        "import gpsat_tpu_torch.data.blosc, gpsat_tpu_torch.data.zarr_reader, gpsat_tpu_torch.data.netcdf\n"
        "import gpsat_tpu_torch.data.dataloader, gpsat_tpu_torch.data.ingest, gpsat_tpu_torch.data.expert_locations\n"
        "import gpsat_tpu_torch.utils, gpsat_tpu_torch.utils.grids, gpsat_tpu_torch.utils.tables\n"
        "import gpsat_tpu_torch.utils.weights, gpsat_tpu_torch.synthetic, gpsat_tpu_torch.config\n"
        "import gpsat_tpu_torch.config_dataclasses, gpsat_tpu_torch.xval, gpsat_tpu_torch.prime_cache\n"
        "import gpsat_tpu_torch.dataloader, gpsat_tpu_torch.dataprepper, gpsat_tpu_torch.vff\n"
        "import gpsat_tpu_torch.prediction_locations, gpsat_tpu_torch.experts, gpsat_tpu_torch.cli\n"
        "import numpy as np, tempfile, os\n"
        "from gpsat_tpu_torch.data import zarr_reader as Z, dataloader as DL\n"
        "d = tempfile.mkdtemp()\n"
        "p = os.path.join(d, 's.zarr')\n"
        "Z.write_zarr(p, {'v': (('index',), np.arange(50.0))}, coords={'index': np.arange(50)}, compress='blosc')\n"
        "assert DL.load(source=p)['v'].tolist() == list(np.arange(50.0))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('h5py', 'pyarrow', 'zstandard', 'jax', 'gpsat_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
