"""The port's data layer against the JAX package's, which is numpy and
needs no JAX compile: tile assembly, local selection, prediction locations
and the HDF5 table store, all held to exact equality. Then the sweep in a
process where pandas and h5py cannot be imported."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.data import prediction_locations as JPL
from gpsat_tpu.data import select as JS
from gpsat_tpu.data.store import TableStore as JStore
from gpsat_tpu.parallel import batching as JB
from gpsat_tpu_torch.data import prediction_locations as TPL
from gpsat_tpu_torch.data import select as TS
from gpsat_tpu_torch.data.store import TableStore as TStore
from gpsat_tpu_torch.parallel import batching as TB

REPO = Path(__file__).resolve().parent.parent
KM = 1000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them, which slows its small CPU ops by orders of
    magnitude (a 8 s test took over 200 s there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(extent_km=700, bin_km=50, seed=0):
    """A binned field: cells on a 50 km lattice, ~60 % occupied, with a time
    column; experts on the 200 km grid, so cells sit at exact multiples of
    the bin width from every expert."""
    rng = np.random.default_rng(seed)
    g = np.arange(-extent_km, extent_km + 1, bin_km) * KM
    xx, yy = np.meshgrid(g, g, indexing="ij")
    cells = np.stack([xx.ravel(), yy.ravel()], axis=1)
    cells = cells[rng.uniform(size=len(cells)) < 0.6]
    t = rng.integers(-6, 7, len(cells)).astype(float)
    z = np.sin(cells[:, 0] / 3e5) + 0.05 * rng.standard_normal(len(cells))
    obs = {"x": cells[:, 0], "y": cells[:, 1], "t": t, "z": z}
    e = np.arange(-600, 601, 200) * KM
    ex, ey = np.meshgrid(e, e, indexing="ij")
    experts = {"x": ex.ravel(), "y": ey.ravel(), "t": np.zeros(ex.size)}
    return obs, experts


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for f in ("X", "y", "mask", "Xnew", "pred_mask", "obs_mean", "expert_index", "num_obs", "expert_loc"):
            a, b = getattr(g, f), getattr(r, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("coalesce", [False, True])
def test_assemble_tiles_matches_jax(coalesce):
    # tiles of 5..300 rows fall in the 128, 256 and 512 buckets; max_batch_size
    # splits each bucket (or, coalesced, the one global shape, evenly)
    rng = np.random.default_rng(3)
    n_obs, E, D = 2000, 11, 2
    coords = rng.uniform(-5e5, 5e5, (n_obs, D))
    obs = rng.standard_normal(n_obs)
    sizes = [5, 300, 130, 64, 128, 129, 17, 250, 90, 256, 1]
    tiles = [np.sort(rng.choice(n_obs, s, replace=False)) for s in sizes]
    preds = [rng.uniform(-5e5, 5e5, (p, D)) for p in (1, 3, 9, 0, 16, 17, 2, 5, 8, 33, 4)]
    kw = dict(
        expert_index=np.arange(E) * 3 + 1,
        expert_locs=rng.uniform(-5e5, 5e5, (E, D)),
        coords_scale=[5e4, 5e4],
        obs_mean="local",
        max_batch_size=3,
        coalesce=coalesce,
    )
    got = TB.assemble_tiles(coords, obs, tiles, preds, **kw)
    ref = JB.assemble_tiles(coords, obs, tiles, preds, **kw)
    _assert_batches_equal(got, ref)
    assert len(got) >= 4
    if coalesce:
        assert len({(b.B, b.Nmax, b.Pmax) for b in got}) == 1 and (got[-1].expert_index == -1).any()


def test_auto_batch_cap_is_none_on_the_cpu():
    assert TB.auto_batch_cap(512) is None and TB.auto_batch_cap(128, device="cpu") is None


def test_local_select_matches_jax_on_the_lattice_boundary():
    obs, experts = _lattice()
    # 300 km is six 50 km bins: "<" keeps d == r, the reference's ball query
    local_select = [
        {"col": ["x", "y"], "comp": "<", "val": 300 * KM},
        {"col": "t", "comp": "<=", "val": 4.0},
        {"col": "t", "comp": ">=", "val": -4.0},
    ]
    got = TS.local_select_indices_all(obs, experts, local_select)
    ref = JS.local_select_indices_all(pd.DataFrame(obs), pd.DataFrame(experts), local_select)
    assert len(got) == len(ref) == len(experts["x"])
    on_boundary = 0
    for e, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g, r)
        d2 = (obs["x"] - experts["x"][e]) ** 2 + (obs["y"] - experts["y"][e]) ** 2
        brute = np.flatnonzero((d2 <= (300 * KM) ** 2) & (np.abs(obs["t"]) <= 4.0))
        np.testing.assert_array_equal(g, brute)
        on_boundary += int((d2[g] == (300 * KM) ** 2).sum())
    assert on_boundary > 0


def test_get_where_list_matches_jax():
    gs = [
        {"col": "date", "comp": ">=", "val": "2020-03-01"},
        {"loc_col": "t", "src_col": "t_src", "func": "lambda x, y: x + y"},
    ]
    ls = [{"col": "t", "comp": "<=", "val": 4}, {"col": "t", "comp": ">=", "val": -4}]
    ref_loc = pd.DataFrame({"x": [1.0], "t": [10.0]})
    assert TS.get_where_list(gs, ls, ref_loc) == JS.get_where_list(gs, ls, ref_loc)
    obs, _ = _lattice()
    wd = [{"col": "t", "comp": ">", "val": 0.0}, {"col": "x", "comp": "<=", "val": 0.0, "negate": True}]
    for combine in ("AND", "OR"):
        np.testing.assert_array_equal(
            TS.row_select_bool(obs, wd, combine=combine), JS.row_select_bool(pd.DataFrame(obs), wd, combine=combine)
        )


@pytest.mark.parametrize(
    "method, kwargs",
    [
        ("from_dataframe", {"max_dist": 200 * KM}),
        ("shift_arrays", {"x": np.array([-25 * KM, 0.0, 25 * KM]), "y": np.array([0.0, 10 * KM])}),
        ("expert_loc", {}),
    ],
)
def test_prediction_locations_match_jax(method, kwargs):
    # a 25 km grid: on-grid experts have grid points at exactly 200 km, which
    # the strict rule (d < max_dist) leaves out
    _, experts = _lattice()
    g = np.arange(-900, 901, 25) * KM
    gx, gy = np.meshgrid(g, g, indexing="ij")
    grid = {"x": gx.ravel(), "y": gy.ravel()}
    coords_col = ["x", "y", "t"]
    extra = {"df": grid} if method == "from_dataframe" else {}
    jextra = {"df": pd.DataFrame(grid)} if method == "from_dataframe" else {}
    got = TPL.PredictionLocations(method, coords_col=coords_col, **kwargs, **extra).batch_call(experts)
    ref = JPL.PredictionLocations(method, coords_col=coords_col, **kwargs, **jextra).batch_call(pd.DataFrame(experts))
    assert len(got) == len(ref) == len(experts["x"])
    for e, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if method == "from_dataframe":
        d2 = (grid["x"] - experts["x"][0]) ** 2 + (grid["y"] - experts["y"][0]) ** 2
        assert (d2 == (200 * KM) ** 2).sum() > 0
        assert len(got[0]) == int((d2 < (200 * KM) ** 2).sum())
        # the per-expert path gives the same rows as the batched query
        pl = TPL.PredictionLocations(method, coords_col=coords_col, df=grid, **kwargs)
        pl.expert_loc = np.array([experts[c][0] for c in coords_col])
        np.testing.assert_array_equal(pl(), got[0])


def test_prediction_locations_from_a_grid_file_match_jax(tmp_path):
    # a config names its grid by df_file: the port reads it once and takes
    # the batched query, the JAX package masks the grid per expert; the
    # same rows either way, and the same as a grid passed as columns
    _, experts = _lattice()
    g = np.arange(-900, 901, 25) * KM
    gx, gy = np.meshgrid(g, g, indexing="ij")
    grid = {"x": gx.ravel(), "y": gy.ravel()}
    path = str(tmp_path / "grid.csv")
    pd.DataFrame(grid).to_csv(path, index=False)
    kw = dict(coords_col=["x", "y", "t"], max_dist=200 * KM)
    got = TPL.PredictionLocations("from_dataframe", df_file=path, **kw).batch_call(experts)
    ref = JPL.PredictionLocations("from_dataframe", df_file=path, **kw).batch_call(pd.DataFrame(experts))
    cols = TPL.PredictionLocations("from_dataframe", df=grid, **kw).batch_call(experts)
    assert len(got) == len(ref) == len(cols) == len(experts["x"])
    for a, b, c in zip(got, ref, cols):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _frame():
    idx = pd.MultiIndex.from_arrays([np.array([1.0, 1.0, 2.0]), np.array([0.5, 0.5, 0.0])], names=["x", "y"])
    return pd.DataFrame(
        {
            "_dim_0": np.array([0, 1, 0]),
            "f*": np.array([0.1, 0.2, 0.3], dtype=np.float32),
            "ok": np.array([True, False, True]),
            "model": np.array(["a", "b", "c"], dtype=object),
            "when": pd.to_datetime(["2020-03-01", "2020-03-02", "2020-03-03"]).values,
        },
        index=idx,
    )


@pytest.mark.parametrize("writer, reader", [(TStore, JStore), (JStore, TStore)])
def test_store_files_read_across_packages(writer, reader, tmp_path):
    path = str(tmp_path / "s.h5")
    with writer(path) as s:
        s.append("t", _frame())
        s.append("t", _frame())
        s.put_attrs("t", note={"k": 1})
    with reader(path, mode="r") as s:
        got = s.select("t")
        assert s.get_attrs("t") == {"note": {"k": 1}}
        sub = s.select("t", where=[{"col": "_dim_0", "comp": "==", "val": 0}, "x >= 1.5"])
    pd.testing.assert_frame_equal(got, pd.concat([_frame(), _frame()]))
    assert len(sub) == 2 and sub.index.names == ["x", "y"]


def test_sweep_runs_without_pandas_and_h5py():
    # the device-facing sweep: columns as a dict of arrays, experts as a dict,
    # a dict grid for the prediction locations, on the CPU, with pandas and
    # h5py (and JAX) unimportable
    code = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "h5py", "jax", "gpsat_tpu"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
import numpy as np, torch
from gpsat_tpu_torch.experts import sweep
from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
rng = np.random.default_rng(0)
x, y = rng.uniform(-3, 3, 100), rng.uniform(-3, 3, 100)
cols = {"x": x, "y": y, "z": np.sin(x) * np.cos(y) + 0.05 * rng.standard_normal(100)}
experts = {"x": np.array([0.0, 1.0, 9.0]), "y": np.array([0.0, 0.5, 9.0])}
g = np.linspace(-3, 3, 13)
grid = {"x": np.repeat(g, 13), "y": np.tile(g, 13)}
out = list(sweep(cols, experts, coords_col=["x", "y"], obs_col="z",
                 local_select=[{"col": ["x", "y"], "comp": "<", "val": 2.0}],
                 pred_loc=PredictionLocations("from_dataframe", coords_col=["x", "y"], df=grid, max_dist=1.0),
                 init_params={"noise_variance": 0.0025, "jitter": 1e-5},
                 optim_kwargs={"max_iter": 30, "polish": "f64", "polish_max_iter": 10},
                 min_obs=5, device="cpu"))
assert out[0]["skipped"] and list(out[0]["expert_index"]) == [2], out[0]
res = out[1]
assert sorted(res["expert_index"]) == [0, 1] and res["f_mean"].dtype == np.float64
assert np.isfinite(res["f_mean"]).all() and res["num_iter"].max() <= 10
assert [len(p) for p in res["pred_coords"]] == list(res["pred_mask"].sum(1).astype(int))
bad = [m for m in sys.modules if m.split(".")[0] in ("pandas", "h5py", "jax", "gpsat_tpu")]
assert not bad, bad
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout + proc.stderr
