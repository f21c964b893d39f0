"""The port's HDF5 codec (gpsat_tpu_torch/data/hdf5.py) under its
``TableStore``, held against h5py and the JAX package's ``TableStore`` in
both directions: what one writes the other reads, appends to and hands
back. Then the workflow's store in a process where h5py cannot be
imported. No JAX program is compiled."""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.data.store import TableStore as JStore
from gpsat_tpu_torch.data import hdf5
from gpsat_tpu_torch.data import pytables_compat as TPT
from gpsat_tpu_torch.data.store import TableStore as TStore

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other port tests pin it under tier-1's
    six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kinds(n, seed=0):
    """Every column kind a store holds, under a two-level index."""
    rng = np.random.default_rng(seed)
    idx = pd.MultiIndex.from_arrays([rng.normal(size=n), rng.integers(0, 3, n).astype(float)], names=["x", "y"])
    df = pd.DataFrame({
        "f8": rng.normal(size=n),
        "f4": rng.normal(size=n).astype(np.float32),
        "i8": rng.integers(-(1 << 40), 1 << 40, n),
        "ok": rng.random(n) > 0.5,
        "ns": np.datetime64("2020-03-01T00:00:00", "ns") + rng.integers(0, 10**15, n).astype("timedelta64[ns]"),
        "us": np.datetime64("2020-03-01T00:00:00", "us") + rng.integers(0, 10**12, n).astype("timedelta64[us]"),
    }, index=idx)
    words = np.array(["sea ice", "glace de mer é", "", None, "морской лёд ❄", "x" * 300], dtype=object)
    df["s"] = pd.Series(words[rng.integers(0, len(words), n)], index=idx, dtype=object)
    return df


def _small(i, n=5):
    return pd.DataFrame({"a": np.arange(n, dtype=float) + n * i, "k": np.arange(n) + n * i,
                         "s": pd.Series([f"r{i}"] * n, dtype=object)})


# each case: the store operations in order, (op, table, argument); "reopen"
# closes the store and opens it again
CASES = {
    "kinds": [("append", "t", _kinds(7)), ("append", "t", _kinds(11, 1)), ("attrs", "t", {"note": {"k": [1, 2]}})],
    "multiindex": [("put", "m", _kinds(5).iloc[:, :2]), ("append", "m", _kinds(4, 2).iloc[:, :2])],
    "many_appends": [op for i in range(200) for op in (("append", "t", _small(i)), ("reopen", None, None))],
    "many_tables": [("put", f"t{j:02d}", _small(j)) for j in range(40)],
    "empty": [("append", "t", _kinds(0)), ("append", "u", _small(0, n=0))],
    "edits": [
        ("append", "t", _small(0)), ("put", "u", _small(1)), ("put", "u", _small(2)), ("reopen", None, None),
        ("attrs", "u", {"a": 1}), ("attrs", "u", {"a": 2, "b": "é"}), ("delete", "t", None),
        ("append", "p", pd.DataFrame({"v": np.array([1, 2], dtype=np.int64)})),
        ("append", "p", pd.DataFrame({"v": np.array([0.5])})),  # the int -> float promotion
    ],
}


def _apply(cls, path, ops, mode="a"):
    s = cls(path, mode=mode)
    try:
        for op, table, arg in ops:
            if op == "append":
                s.append(table, arg)
            elif op == "put":
                s.put(table, arg)
            elif op == "delete":
                s.delete(table)
            elif op == "attrs":
                s.put_attrs(table, **arg)
            else:
                s.close()
                s = cls(path, mode="a")
    finally:
        s.close()


def _contents(cls, path):
    with cls(path, mode="r") as s:
        return {t: (s.select(t), s.get_attrs(t)) for t in s.keys()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for t, (frame, attrs) in want.items():
        pd.testing.assert_frame_equal(got[t][0], frame, obj=t)
        assert got[t][1] == attrs, t


def _extra(contents):
    """One more append to the first table: a frame of its own rows."""
    table = sorted(contents)[0]
    frame = contents[table][0]
    return table, frame.iloc[: max(len(frame) // 2, 0)]


def _h5py_reads(path):
    """h5py opens every column: resizable 1-D chunked datasets with a
    dtype_tag, all of one length per table."""
    with h5py.File(path, "r") as f:
        for t in f:
            lens = set()
            for c in json.loads(f[t].attrs["columns"]):
                ds = f[t][c]
                assert ds.maxshape == (None,) and ds.chunks is not None and "dtype_tag" in ds.attrs, (t, c)
                lens.add(len(ds[...]))
            assert len(lens) <= 1, (t, lens)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_round_trips_against_h5py_and_jax(case, writer, tmp_path):
    # the JAX package's store, through h5py, is the reference: the same
    # operations, then one more append by the other package, and each side
    # reads back the other's file equal to the reference
    ref, path = str(tmp_path / "ref.h5"), str(tmp_path / "s.h5")
    _apply(JStore, ref, CASES[case])
    mine, other = (TStore, JStore) if writer == "port" else (JStore, TStore)
    _apply(mine, path, CASES[case])
    want = _contents(JStore, ref)
    _assert_same(_contents(other, path), want)
    _h5py_reads(path)
    table, frame = _extra(want)
    for cls, p in ((JStore, ref), (other, path)):
        with cls(p) as s:
            s.append(table, frame)
    want = _contents(JStore, ref)
    _assert_same(_contents(mine, path), want)
    _assert_same(_contents(other, path), want)
    _h5py_reads(path)


def _btree_root(path, table, column):
    """The level and entry count of a column's chunk B-tree root, and the
    number of symbol-table nodes under the root group, read from the file."""
    with hdf5.File(path, "r") as f:
        ds = f[table][column]
        level, n = f._read(ds._index, 8)[5], struct.unpack("<H", f._read(ds._index, 8)[6:8])[0]
        btree = f.root._btree
        snods = struct.unpack("<H", f._read(btree, 8)[6:8])[0]
    return level, n, snods


@pytest.mark.parametrize("writer", [TStore, JStore])
def test_multi_level_btrees_and_several_symbol_nodes(writer, tmp_path):
    # 200 appends of 5 rows: 200 chunks of 5 (h5py's guess), more than the
    # 64 a node holds, so the chunk B-tree has two levels; 40 tables fill
    # several symbol-table nodes of 8. Both writers' files read in both.
    path = str(tmp_path / "s.h5")
    _apply(writer, path, CASES["many_appends"] + CASES["many_tables"])
    level, n, snods = _btree_root(path, "t", "a")
    assert level == 1 and n >= 4, (level, n)
    assert snods >= 5, snods
    for reader in (TStore, JStore):
        with reader(path, mode="r") as s:
            np.testing.assert_array_equal(s.select("t")["a"].to_numpy(), np.arange(1000.0))
            assert len(s.keys()) == 41


def test_codec_chunks_and_attributes_read_in_h5py(tmp_path):
    # the codec's own surface: chunks as h5py guesses them, str attributes,
    # variable-length strings, appends past a partial chunk
    path = str(tmp_path / "c.h5")
    with hdf5.File(path, "w") as f:
        g = f.create_group("g")
        g.attrs["note"] = "é"
        ds = g.create_dataset("v", np.arange(5.0))
        ds.append(np.arange(5.0, 12.0))
        s = g.create_dataset("s", np.array(["a", "", "ü"], dtype=object))
        assert ds.chunks == (5,) and list(ds.read()) == list(np.arange(12.0))
        assert list(s.read()) == ["a", "", "ü"]
    with h5py.File(path, "r") as f:
        assert f["g"].attrs["note"] == "é"
        assert f["g/v"].chunks == (5,) and f["g/v"].maxshape == (None,)
        np.testing.assert_array_equal(f["g/v"][...], np.arange(12.0))
        assert list(f["g/s"].asstr()[...]) == ["a", "", "ü"]
    with h5py.File(path, "a") as f:
        f["g/v"].resize((14,))
        f["g/v"][12:] = [12.0, 13.0]
        f["g"].attrs["more"] = "x" * 200
    with hdf5.File(path, "r") as f:
        np.testing.assert_array_equal(f["g"]["v"].read(), np.arange(14.0))
        assert f["g"].attrs["more"] == "x" * 200 and f["g"].attrs["note"] == "é"


@pytest.mark.parametrize("kind", ["missing", "not_hdf5", "latest_format", "compressed", "layout_v4", "unknown_filter"])
def test_codec_refuses_what_it_does_not_read(kind, tmp_path):
    # what the codec does not read raises; HDF5's latest format (superblock 3,
    # version-2 headers, a version-4 layout) and compressed columns (deflate,
    # lzf) read as h5py reads them, and an append to a later-format or
    # compressed store is written as h5py reads it; a column that is not
    # resizable (contiguous, or chunked without a maximum) is refused and
    # the file left as it was
    path = str(tmp_path / "f.h5")
    if kind == "missing":
        with pytest.raises(FileNotFoundError):
            TStore(path, mode="r")
        assert not os.path.exists(path)
        return
    if kind == "not_hdf5":
        Path(path).write_text("x,y\n1,2\n")
        with pytest.raises(OSError, match="not an HDF5 file"):
            TStore(path, mode="r")
        assert not TPT.is_pytables_store(path)
        return
    libver = "latest" if kind in ("latest_format", "layout_v4") else "earliest"
    with h5py.File(path, "w", libver=libver) as f:
        kw = {"latest_format": {}, "compressed": dict(maxshape=(None,), compression="gzip"),
              "layout_v4": dict(maxshape=(None,)), "unknown_filter": dict(chunks=(8,), compression="lzf")}[kind]
        f.create_dataset("t/a", data=np.arange(30.0), **kw)
        f["t"].attrs["columns"], f["t"].attrs["index_cols"] = '["a"]', "[]"
        f["t/a"].attrs["dtype_tag"] = "<f8"
    with TStore(path, mode="r") as s:
        assert s.keys() == ["t"]
        with h5py.File(path, "r") as f:
            want = f["t/a"][()]
        np.testing.assert_array_equal(s.select("t")["a"].to_numpy(), want)
    if kind in ("latest_format", "unknown_filter"):
        with TStore(path, mode="a") as s, pytest.raises(OSError, match="not resizable"):
            s.append("t", pd.DataFrame({"a": [1.0]}))
    else:
        with TStore(path, mode="a") as s:
            s.append("t", pd.DataFrame({"a": [1.0, 2.0]}))
        want = np.r_[want, 1.0, 2.0]
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["t/a"][()], want)
    with TStore(path, mode="r") as s:
        np.testing.assert_array_equal(s.select("t")["a"].to_numpy(), want)


# the workflow's stores with h5py unimportable: LocalExpertOI.run on
# tests/test_torch_oi.py's data (f32, few iterations), and its CLI config
# with the observations in a .h5 store and the experts in a CSV file,
# through `cli local_expert_oi`, `cli postprocessing` and the predict-only
# re-run from the config that postprocessing writes; stores in STORE_DIR
WORKFLOW = r"""
import json
import numpy as np, pandas as pd, torch
from gpsat_tpu_torch import cli
from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.experts import LocalExpertOI
torch.set_num_threads(1)
rng = np.random.default_rng(11)
n = 500
x, y = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
t = rng.integers(0, 3, n).astype(float)
obs = np.sin(x) * np.cos(y) + 0.1 * rng.normal(size=n)
obs_df = pd.DataFrame({"x": x, "y": y, "t": t, "obs": obs})
expert_df = pd.DataFrame({"x": [3.0, 3.0, 7.0, 7.0], "y": [3.0, 7.0, 3.0, 7.0], "t": [1.0, 1.0, 1.0, 1.0]})
data = {"data_source": obs_df, "obs_col": "obs", "coords_col": ["x", "y", "t"],
        "local_select": [{"col": ["x", "y"], "comp": "<", "val": 4.0}, {"col": "t", "comp": "<=", "val": 1.0},
                         {"col": "t", "comp": ">=", "val": -1.0}]}
model = {"oi_model": "GPflowGPRModel", "init_params": {"kernel": "Matern32", "noise_variance": 0.01},
         "constraints": {"lengthscales": {"low": 0.1, "high": 20.0}}, "optim_kwargs": {"max_iter": 15}}
pred_loc = {"method": "shift_arrays", "x": [-0.5, 0.0, 0.5], "y": [0.0]}
LocalExpertOI(expert_loc_config={"source": expert_df}, data_config=data, model_config=model,
              pred_loc_config=pred_loc).run(store_path=STORE_DIR + "/run.h5", device="cpu")

with TableStore(STORE_DIR + "/obs.h5", mode="w") as s:
    s.append("data", obs_df)
expert_df.iloc[:2].to_csv(STORE_DIR + "/experts.csv", index=False)
config = {"comment": "two experts", "locations": {"source": STORE_DIR + "/experts.csv"},
          "data": {**data, "data_source": STORE_DIR + "/obs.h5", "table": "data"}, "model": model,
          "pred_loc": pred_loc, "run_kwargs": {"store_path": STORE_DIR + "/cli.h5", "device": "cpu",
                                               "dtype": "float32", "min_obs": 10}}
post = {"result_file": STORE_DIR + "/cli.h5", "device": "cpu",
        "params_to_smooth": ["lengthscales", "kernel_variance", "likelihood_variance"],
        "smooth_config_dict": {p: {"l_x": 3.0, "l_y": 3.0} for p in ["lengthscales", "kernel_variance",
                                                                    "likelihood_variance"]}}
for name, cfg in (("oi.json", config), ("post.json", post)):
    with open(f"{STORE_DIR}/{name}", "w") as f:
        json.dump(cfg, f)
assert cli.main(["local_expert_oi", STORE_DIR + "/oi.json"]) == 0
assert cli.main(["postprocessing", STORE_DIR + "/post.json"]) == 0
with open(STORE_DIR + "/cli_SMOOTHED.json") as f:
    rerun = json.load(f)  # a list of configs; the run's device is not stored
for cfg in rerun:
    cfg["run_kwargs"]["device"] = "cpu"
with open(STORE_DIR + "/rerun.json", "w") as f:
    json.dump(rerun, f)
assert cli.main(["local_expert_oi", STORE_DIR + "/rerun.json"]) == 0
"""

BLOCKED = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("h5py", "jax", "gpsat_tpu"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
STORE_DIR, PYTABLES, NETCDF = sys.argv[1:4]
""" + WORKFLOW + r"""
import pandas as pd
from gpsat_tpu_torch.data import pytables_compat as PT
from gpsat_tpu_torch.data import dataloader as DL
from gpsat_tpu_torch.data.ingest import read_and_store
from gpsat_tpu_torch.data.netcdf import read_netcdf, write_netcdf
# a port-format store opens through open_store and the dataloader
with PT.open_store(STORE_DIR + "/run.h5") as s:
    assert "preds" in s.keys() and len(s.select("preds")) == 12
assert len(DL.load(STORE_DIR + "/run.h5", table="run_details")) == 4
# a PyTables file and a netCDF4 file read, and a netCDF file is written
assert PT.is_pytables_store(PYTABLES) and PT.list_tables(PYTABLES) == ["data", "lengthscales"]
frames = {"read_table": PT.read_table(PYTABLES, "data"), "select": PT.open_store(PYTABLES).select("lengthscales"),
          "dl_load": DL.load(PYTABLES, table="data"), "read_netcdf": read_netcdf(NETCDF)}
write_netcdf(STORE_DIR + "/written.nc", frames["read_table"])
read_and_store({"file": STORE_DIR + "/ingest.h5", "table": "data"}, STORE_DIR, r"written\.nc", read_engine="nc")
frames["read_and_store"] = DL.load(STORE_DIR + "/ingest.h5", table="data")
pd.to_pickle(frames, STORE_DIR + "/frames.pkl")
bad = [m for m in sys.modules if m.split(".")[0] in ("h5py", "jax", "gpsat_tpu")]
assert not bad, bad
print("ok")
"""


def _store_frames(path):
    """Every table of a results store, the columns that carry a clock time
    or a path left out."""
    out = {}
    with TStore(path, mode="r") as s:
        for t in s.keys():
            df = s.select(t, set_index=False)
            out[t] = df.drop(columns=[c for c in ("run_time", "datetime", "config") if c in df.columns])
    return out


def test_workflow_store_without_h5py_matches_with_h5py(tmp_path):
    # the same run and CLI call in a process where h5py (and JAX) cannot be
    # imported and here, where it can: equal frames in every table. In that
    # process a port store opens through open_store and the dataloader, a
    # PyTables file reads through read_table, PyTablesStore.select and the
    # dataloader, a netCDF4 file (netCDF-C's layout) through read_netcdf, a
    # frame is written by write_netcdf and ingested by read_and_store with
    # the nc engine: each frame equal to the JAX package's h5py readers' on
    # the same files
    import importlib.util

    from gpsat_tpu.data import dataloader as JDL
    from gpsat_tpu.data import ingest as JI
    from gpsat_tpu.data import netcdf as JN
    from gpsat_tpu.data import pytables_compat as JPT

    spec = importlib.util.spec_from_file_location("make_hdf5_fixtures", REPO / "tools" / "make_hdf5_fixtures.py")
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    pytables, netcdf = str(tmp_path / "pytables.h5"), str(tmp_path / "obs.nc")
    fx.write_pytables(pytables, "zlib", n=50)
    fx.write_netcdf_variant(netcdf, libver="v108", track_order=True, layout="filtered")

    blocked, here = tmp_path / "blocked", tmp_path / "here"
    blocked.mkdir()
    here.mkdir()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(blocked), pytables, netcdf], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout[-3000:] + proc.stderr[-3000:]
    exec(WORKFLOW, {"STORE_DIR": str(here)})
    for name in ("run.h5", "cli.h5"):
        got, want = _store_frames(str(blocked / name)), _store_frames(str(here / name))
        assert sorted(got) == sorted(want) and "preds" in got, name
        for t in want:
            pd.testing.assert_frame_equal(got[t], want[t], obj=f"{name} {t}")
    assert "preds_SMOOTHED" in _store_frames(str(blocked / "cli.h5"))

    frames = pd.read_pickle(blocked / "frames.pkl")
    JN.write_netcdf(str(here / "written.nc"), JPT.read_table(pytables, "data"))
    JI.read_and_store({"file": str(here / "ingest.h5"), "table": "data"}, str(here), r"written\.nc", read_engine="nc")
    want = {"read_table": JPT.read_table(pytables, "data"), "select": JPT.read_table(pytables, "lengthscales"),
            "dl_load": JDL.load(pytables, table="data"), "read_netcdf": JN.read_netcdf(netcdf),
            "read_and_store": JDL.load(str(here / "ingest.h5"), table="data")}
    assert len(want["read_and_store"]) == len(want["read_table"]) == 50
    for k, w in want.items():
        pd.testing.assert_frame_equal(frames[k], w, obj=k)
    # the netCDF file written without h5py reads in the JAX package as the one it writes
    pd.testing.assert_frame_equal(JN.read_netcdf(str(blocked / "written.nc")), JN.read_netcdf(str(here / "written.nc")))
