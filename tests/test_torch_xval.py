"""The port's host-side tools against the JAX package's, on the CPU: the
cross-validation expansion and scoring (xval.py), priming (prime_cache.py),
the grid, table and weight utilities, expert locations, synthetic truth,
the config dataclasses, and the helpers added to utils.misc, data.select
and experts. Everything compared is host code in both packages: no JAX
program is compiled."""

import json
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import gpsat_tpu.config as JCFG
import gpsat_tpu.synthetic as JSYN
import gpsat_tpu.utils.misc as JMISC
import gpsat_tpu.xval as JX
from gpsat_tpu import get_config_path
from gpsat_tpu.data import expert_locations as JEL
from gpsat_tpu.data import select as JSEL
from gpsat_tpu.data.store import TableStore as JStore
from gpsat_tpu.experts import LocalExpertData as JData
from gpsat_tpu.experts import LocalExpertOI as JOI
from gpsat_tpu.utils import grids as JG
from gpsat_tpu.utils import tables as JT
from gpsat_tpu.utils import weights as JW
import gpsat_tpu_torch.config as TCFG
import gpsat_tpu_torch.config_dataclasses as TCD
import gpsat_tpu_torch.synthetic as TSYN
import gpsat_tpu_torch.utils as TU
import gpsat_tpu_torch.utils.misc as TMISC
import gpsat_tpu_torch.xval as TX
from gpsat_tpu_torch import cli, experts as TEXP
from gpsat_tpu_torch.data import expert_locations as TEL
from gpsat_tpu_torch.data import select as TSEL
from gpsat_tpu_torch.experts import LocalExpertData as TData
from gpsat_tpu_torch.experts import LocalExpertOI as TOI
from gpsat_tpu_torch.parallel.engine import padded_width
from gpsat_tpu_torch.prime_cache import prime
from gpsat_tpu_torch.utils import grids as TG
from gpsat_tpu_torch.utils import tables as TT
from gpsat_tpu_torch.utils import weights as TW

# the scores: the same f64 glue and sums in both packages
SCORE_BOUND = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon(x):
    return json.dumps(JMISC.json_serializable(x), sort_keys=True, default=str)


def tracks_csv(tmp_path, n_tracks=4, n_per=40, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"x": rng.uniform(-3, 3, n_tracks * n_per), "y": rng.uniform(-3, 3, n_tracks * n_per),
                       "track": np.repeat(np.arange(n_tracks), n_per),
                       "date": np.repeat(["2020-03-01", "2020-03-02"], n_tracks * n_per // 2)})
    df["z"] = np.sin(df["x"]) * np.cos(df["y"]) + 0.05 * rng.normal(size=len(df))
    path = str(tmp_path / "obs.csv")
    df.to_csv(path, index=False)
    return df, path


def ref_config(data_path, locs_path):
    return {
        "data": {"data_source": data_path, "obs_col": "z", "coords_col": ["x", "y"], "where": [],
                 "local_select": [{"col": ["x", "y"], "comp": "<", "val": 4.0}]},
        "locations": {"source": locs_path},
        "model": {"oi_model": "GPflowGPRModel", "optim_kwargs": {"max_iter": 50}},
        "run_kwargs": {"store_path": "out.h5", "table_suffix": "_r"},
        "pred_loc": {"method": "expert_loc"},
        "comment": "reference",
    }


@pytest.mark.parametrize("wheres", [None, {"date": ["2020-03-01", "2020-03-02"]}])
def test_xval_configs_json_equal_to_jax(wheres, tmp_path):
    _, data = tracks_csv(tmp_path)
    locs = str(tmp_path / "locs.csv")
    pd.DataFrame({"x": [0.0, 1.0], "y": [0.0, -1.0]}).to_csv(locs, index=False)
    xc = {"pred_loc": {"method": "from_source"}, "row_select_values": ["track"],
          "func": "lambda track: track == {track}", "col_args": ["track"], "output_file": "xval.h5"}
    if wheres:
        xc["wheres"] = wheres
    for kw in ({}, {"add_where_as_col_to_location": True, "add_to_table_suffix": False}):
        got = TX.XvalConfig(ref_config(data, locs), dict(xc)).make_xval_oi_configs(**kw)
        want = JX.XvalConfig(ref_config(data, locs), dict(xc)).make_xval_oi_configs(**kw)
        assert len(got) == 4  # two tracks per date
        assert canon(got) == canon(want)


def test_xval_main_writes_the_jax_configs(tmp_path, monkeypatch):
    # xval.main through the dispatcher and the JAX package's main write
    # the same file of hold-out configs
    _, data = tracks_csv(tmp_path, seed=1)
    locs = str(tmp_path / "locs.csv")
    pd.DataFrame({"x": [0.0], "y": [0.0]}).to_csv(locs, index=False)
    base = {"ref_config": ref_config(data, locs),
            "xval_config": {"pred_loc": {"method": "from_source"}, "row_select_values": ["track"],
                            "func": "lambda track: track == {track}", "col_args": "track"}}
    outs = {}
    for tag, run in (("port", None), ("jax", JX.main)):
        cfg = dict(base, output_config_file=str(tmp_path / f"{tag}_configs.json"))
        if run is None:
            path = tmp_path / "xval.json"
            path.write_text(json.dumps(cfg))
            monkeypatch.setattr(sys, "argv", list(sys.argv))
            assert cli.main(["xval", str(path)]) == 0
        else:
            run(cfg)
        outs[tag] = json.loads((tmp_path / f"{tag}_configs.json").read_text())
    assert len(outs["port"]) == 4 and outs["port"] == outs["jax"]
    monkeypatch.setattr(sys, "argv", ["xval"])
    assert TX.main() == 2  # no config: the usage, rc 2


def test_evaluate_xval_results_match_jax(tmp_path):
    # the same preds tables scored by both packages (from a store), and by
    # the port's frame-level scorer without the store
    rng = np.random.default_rng(2)
    frames = {}
    for t in range(3):
        xe = np.repeat([-1.0, 1.0], 30)
        px = np.tile(np.round(rng.uniform(-2, 2, 30), 3), 2)
        py = np.tile(np.round(rng.uniform(-2, 2, 30), 3), 2)
        frames[f"preds_{t}"] = pd.DataFrame({"x": xe, "y": np.zeros(60), "pred_loc_x": px, "pred_loc_y": py,
                                             "f*": np.sin(px) + 0.1 * rng.normal(size=60),
                                             "y_var": rng.uniform(0.01, 0.1, 60)})
    store = str(tmp_path / "xval.h5")
    with JStore(store) as s:
        for t, df in frames.items():
            s.put(t, df.set_index(["x", "y"]))
        s.put("run_details", pd.DataFrame({"x": [0.0], "n": [1]}).set_index("x"))
    truth = pd.concat(frames.values())[["pred_loc_x", "pred_loc_y"]].drop_duplicates()
    truth["truth"] = np.sin(truth["pred_loc_x"])
    kw = dict(inference_radius=2.0, join_round=6)
    want = JX.evaluate_xval_results(store, truth, "truth", **kw)
    got = TX.evaluate_xval_results(store, truth, "truth", **kw)
    framed = TX.score_xval_predictions(frames, truth, "truth", **kw)
    assert list(want["table"]) == ["preds_0", "preds_1", "preds_2", "MEAN"]
    for out in (got, framed):
        assert list(out["table"]) == list(want["table"]) and list(out["n"]) == list(want["n"])
        np.testing.assert_allclose(out[["rmse", "nll"]].to_numpy(), want[["rmse", "nll"]].to_numpy(),
                                   rtol=SCORE_BOUND, atol=0)


@pytest.mark.parametrize("mesh, pad_multiple", [(None, None), (None, 4), (3, None), (3, 4)])
def test_prime_pads_as_the_engine(mesh, pad_multiple):
    shapes = [(5, 16, 4), (9, 8, 2)]
    res = prime(shapes, device="cpu", mesh=mesh, pad_multiple=pad_multiple, verbose=False)
    n_dev = 1 if mesh is None else mesh
    assert set(res["libraries"]) == {"gpsat_native"}  # no CUDA kernel on the CPU
    for B, N, P in shapes:
        assert res["shapes"][(B, N, P)]["padded_width"] == padded_width(B, pad_multiple, n_dev)
        assert res["shapes"][(B, N, P)]["seconds"] > 0


def test_prime_defaults_to_the_card(monkeypatch):
    # no device given: the card, which must exist; no library is built
    # before the refusal
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be observed")
    import gpsat_tpu_torch.prime_cache as TPC

    monkeypatch.setattr(TPC, "build_libraries", lambda on_card: pytest.fail("built before the refusal"))
    with pytest.raises(RuntimeError, match="CUDA"):
        prime([(4, 8, 2)], verbose=False)
    monkeypatch.setattr(sys, "argv", ["prime_cache"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TPC.main(["--shapes", "4x8x2"])


def test_grids_tables_weights_match_jax():
    for kw in ({"grid_res": 50.0}, {"step_size": 100.0}, {"num_step": 7}):
        for center in (True, False):
            np.testing.assert_array_equal(TG.grid_2d_flatten([-200, 300], [0, 450], center=center, **kw),
                                          JG.grid_2d_flatten([-200, 300], [0, 450], center=center, **kw))
    np.testing.assert_array_equal(TG.grid_nd_flatten([[0, 4], [1, 3], [0, 2]], grid_res=1.0),
                                  JG.grid_nd_flatten([[0, 4], [1, 3], [0, 2]], grid_res=1.0))

    rng = np.random.default_rng(3)
    arrays = {"ls": rng.normal(size=(2, 3)), "kv": 1.5, "nv": rng.normal(size=4)}
    for concat in (False, True):
        got = TT.dict_of_array_to_dict_of_dataframe(arrays, concat=concat, reset_index=True)
        want = JT.dict_of_array_to_dict_of_dataframe(arrays, concat=concat, reset_index=True)
        assert list(got) == list(want)
        for k in want:
            pd.testing.assert_frame_equal(got[k], want[k])
    df = TT.array_to_dataframe(arrays["ls"], "ls")
    pd.testing.assert_frame_equal(df, JT.array_to_dataframe(arrays["ls"], "ls"))
    np.testing.assert_array_equal(TT.dataframe_to_array(df, "ls"), JT.dataframe_to_array(df, "ls"))
    idx = {"x": 1.0, "y": 2.0}
    for k, v in TT.make_multiindex_df(idx, ls=arrays["ls"]).items():
        pd.testing.assert_frame_equal(v, JT.make_multiindex_df(idx, ls=arrays["ls"])[k])
        g_vals, g_locs = TT.mindex_df_to_dataarray(v, "ls")
        w_vals, w_locs = JT.mindex_df_to_dataarray(v, "ls")
        np.testing.assert_array_equal(g_vals, w_vals)
        assert list(g_locs) == list(w_locs)
    grid = pd.DataFrame({"x": [0.0, 1.0, 0.0], "y": [5.0, 5.0, 6.0], "v": [1.0, 2.0, 3.0]})
    for got, want in zip(TT.dataframe_to_2d_array(grid, "x", "y", "v"), JT.dataframe_to_2d_array(grid, "x", "y", "v")):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TT.match(["b", "c"], ["a", "b", "c"]), JT.match(["b", "c"], ["a", "b", "c"]))

    preds = pd.DataFrame({"px": rng.integers(0, 5, 200).astype(float), "py": rng.integers(0, 3, 200).astype(float),
                          "ex": rng.normal(size=200), "ey": rng.normal(size=200), "f": rng.normal(size=200),
                          "g": rng.normal(size=200)})
    preds.loc[::17, "f"] = np.nan
    preds.loc[5, "px"] = np.nan
    for drop in (True, False):
        got = TW.get_weighted_values(preds, ["px", "py"], ["ex", "ey"], ["f", "g"], lengthscale=1.3,
                                     drop_weight_cols=drop)
        want = JW.get_weighted_values(preds, ["px", "py"], ["ex", "ey"], ["f", "g"], lengthscale=1.3,
                                      drop_weight_cols=drop)
        pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12, atol=0)


def test_expert_locations_and_synthetic_match_jax():
    np.testing.assert_array_equal(TEL.sparse_true_array((6, 5), 2, 1), JEL.sparse_true_array((6, 5), 2, 1))
    np.testing.assert_array_equal(TU.sparse_true_array((7,), 3), JEL.sparse_true_array((7,), 3))
    rng = np.random.default_rng(4)
    ref = pd.DataFrame({"x": np.repeat(np.arange(6.0), 4), "y": np.tile(np.arange(4.0), 6),
                        "date": "2020-03-01", "obs": rng.normal(size=24)})
    ref.loc[ref.x == 2.0, "obs"] = np.nan
    masks_t = TEL.get_masks_for_expert_loc(ref, ["had_obs", {"grid_space": 2, "dims": ["x", "y"]}], obs_col="obs",
                                           dims=["x", "y"])
    masks_j = JEL.get_masks_for_expert_loc(ref, ["had_obs", {"grid_space": 2, "dims": ["x", "y"]}], obs_col="obs",
                                           dims=["x", "y"])
    for g, w in zip(masks_t, masks_j):
        pd.testing.assert_frame_equal(g, w)
    kw = dict(ref_data=ref, col_func_dict={"r": {"source": "numpy", "func": "hypot", "col_args": ["x", "y"]}},
              row_select=[{"col": "y", "comp": "<", "val": 3.0}], sort_by="r")
    got = TEL.generate_local_expert_locations({"x": "x", "y": np.arange(4.0)}, masks=masks_t, **kw)
    want = JEL.generate_local_expert_locations({"x": "x", "y": np.arange(4.0)}, masks=masks_j, **kw)
    pd.testing.assert_frame_equal(got, want)
    assert 0 < len(got) < 24

    f_t, xg_t, yg_t = TSYN.make_ground_truth_field(extent=5e5, n=41, seed=0)
    f_j, xg_j, yg_j = JSYN.make_ground_truth_field(extent=5e5, n=41, seed=0)
    for a, b in ((f_t, f_j), (xg_t, xg_j), (yg_t, yg_j)):
        np.testing.assert_array_equal(a, b)
    tr = TSYN.make_tracks(extent=5e5, n_tracks=6, pts_per_track=50, seed=1)
    pd.testing.assert_frame_equal(tr, JSYN.make_tracks(extent=5e5, n_tracks=6, pts_per_track=50, seed=1))
    kw = dict(noise_std=0.05, seed=2, keep_cols=["track"])
    pd.testing.assert_frame_equal(TSYN.sample_from_ground_truth(tr, f_t, xg_t, yg_t, **kw),
                                  JSYN.sample_from_ground_truth(tr, f_j, xg_j, yg_j, **kw))


def test_config_round_trip_matches_jax():
    # every example OI config through ExperimentConfig, the legacy names out
    for name in ("example_local_expert_oi.json", "example_local_expert_oi_svgp.json",
                 "example_local_expert_oi_reference_for_xval.json", "sea_ice_freeboard_oi.json"):
        with open(get_config_path(name)) as f:
            cfg = json.load(f)
        got = TCFG.ExperimentConfig.from_dict(cfg)
        want = JCFG.ExperimentConfig.from_dict(cfg)
        assert canon(got.to_dict()) == canon(want.to_dict()), name
        assert canon(TCFG.ExperimentConfig.from_dict(got.to_dict()).to_dict()) == canon(got.to_dict()), name
    legacy = {"data_config": {"obs_col": "z"}, "model_config": {"oi_model": "GPflowSGPRModel"},
              "local_expert_locations": {"source": "a.csv"}, "pred_loc_config": {"method": "shift_arrays", "x": [1]},
              "run_config": {"min_obs": 5}}
    assert canon(TCD.ExperimentConfig.from_dict(legacy).to_dict()) == canon(
        JCFG.ExperimentConfig.from_dict(legacy).to_dict())
    assert TCD.__all__ == ["DataConfig", "ExperimentConfig", "ExpertLocsConfig", "ModelConfig",
                           "PredictionLocsConfig", "RunConfig"]


def test_misc_select_and_experts_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    y, mu, sig = rng.normal(size=20), rng.normal(size=20), rng.uniform(0.5, 2, 20)
    assert TMISC.rmse(y, mu) == JMISC.rmse(y, mu)
    assert TMISC.nll(y, mu, sig) == JMISC.nll(y, mu, sig)
    np.testing.assert_array_equal(TMISC.nll(y, mu, sig, return_mean=False), JMISC.nll(y, mu, sig, return_mean=False))
    xs = np.array([0.0, 1.0, 1.5, 9.0, 9.5, 30.0])
    np.testing.assert_array_equal(TMISC.guess_track_num(xs, 5.0, 1), JMISC.guess_track_num(xs, 5.0, 1))
    times = pd.to_datetime(["2020-03-01 00:00:00", "2020-03-01 00:00:30", "2020-03-01 02:00:00",
                            "2020-03-02 01:00:00"])
    np.testing.assert_array_equal(TMISC.track_num_for_date(times), JMISC.track_num_for_date(times))
    np.testing.assert_array_equal(TMISC.diff_distance(xs, 2), JMISC.diff_distance(xs, 2))
    np.testing.assert_array_equal(TMISC.not_nan([1.0, np.nan]), JMISC.not_nan([1.0, np.nan]))
    assert TMISC.convert_lon_lat_str("140 0.1198 W") == JMISC.convert_lon_lat_str("140 0.1198 W")
    d = {"a": [1, 2], "b": "x", "c": [3, 4]}
    assert TMISC.expand_dict_by_vals(d, ["a", "c"]) == JMISC.expand_dict_by_vals(d, ["a", "c"])
    assert TMISC.pretty_print_class(TOI) == "gpsat_tpu_torch.experts.LocalExpertOI"
    df1 = pd.DataFrame({"k": [1, 2, 3], "v": [1.0, 2.0, 4.0]})
    df2 = pd.DataFrame({"k": [1, 2, 4], "v": [1.0, 2.5, 4.0]})
    pd.testing.assert_frame_equal(TMISC.compare_dataframes(df1, df2, "k", ["v"]),
                                  JMISC.compare_dataframes(df1, df2, "k", ["v"]))
    cat = TMISC.assign_category_col("a", df1, categories=["a", "b"])
    assert list(cat) == list(JMISC.assign_category_col("a", df1, categories=["a", "b"])) and len(cat) == 3
    (tmp_path / "c.json").write_text(json.dumps({"('x', 'y')": {"func": "f"}}))
    assert TMISC.json_load(str(tmp_path / "c.json")) == JMISC.json_load(str(tmp_path / "c.json"))
    for f in ("a.txt", "b.txt"):
        (tmp_path / f).write_text(f)
    TMISC.move_to_archive(str(tmp_path), ["a.txt", "missing.txt"], suffix="_1")
    assert (tmp_path / "Archive" / "a_1.txt").read_text() == "a.txt" and (tmp_path / "b.txt").exists()
    assert TU.rmse is TMISC.rmse and TU.get_weighted_values is TW.get_weighted_values
    assert TU.log_lines("x") is None and TU.inverse_sigmoid(0.5) == 0.0
    with pytest.raises(AttributeError):
        TU.no_such_name

    # one expert's window: the bool mask, the frame, pre-built trees and
    # the legacy where strings
    pts = pd.DataFrame({"x": np.round(rng.uniform(0, 10, 300)), "y": np.round(rng.uniform(0, 10, 300)),
                        "t": rng.integers(0, 9, 300)})
    ref = pd.Series({"x": 5.0, "y": 5.0, "t": 4})
    ls = [{"col": ["x", "y"], "comp": "<", "val": 3.0}, {"col": "t", "comp": "<=", "val": 2}]
    trees = TSEL.build_kdtrees(pts, ls)
    assert trees[1] is None and trees[0].n == 300
    for kdtree in (None, trees):
        got = TSEL.local_select_bool(pts, ref, ls, kdtree=kdtree)
        np.testing.assert_array_equal(got, JSEL.local_select_bool(pts, ref, ls))
        np.testing.assert_array_equal(np.flatnonzero(got), TSEL.local_select_indices_all(pts, ref.to_frame().T, ls)[0])
    pd.testing.assert_frame_equal(TSEL.local_data_select(pts, ref, ls), JSEL.local_data_select(pts, ref, ls))
    rib = {"date": {"values": ["2020-03-01", "2020-03-03"], "how": "interval"}, "sat": {"values": [1, 2], "how": "=="}}
    assert TSEL.get_where_list_legacy(rib) == JSEL.get_where_list_legacy(rib)
    assert TSEL.get_where_list_legacy(None, "a > 1") == JSEL.get_where_list_legacy(None, "a > 1")

    for source in ("obs.zarr", "obs.parquet", "obs.nc", pd.DataFrame()):
        got, want = TData(data_source=source), JData(data_source=source)
        got.set_data_source()
        want.set_data_source()
        assert got.engine == want.engine
    x = {"ls": np.arange(6.0).reshape(2, 3), "kv": np.array([1.5])}
    for kw in ({}, {"ref_loc": pd.Series({"x": 1.0, "y": 2.0})}, {"ref_loc": {"x": 1.0}, "concat": True,
                                                                  "table": "params"}):
        got, want = TOI.dict_of_array_to_table(x, **kw), JOI.dict_of_array_to_table(x, **kw)
        assert list(got) == list(want)
        for k in want:
            pd.testing.assert_frame_equal(got[k], want[k])
    assert isinstance(TEXP.get_phase_timers(), dict)
