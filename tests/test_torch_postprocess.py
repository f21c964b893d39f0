"""The port's post-processing (gpsat_tpu_torch/postprocess.py), parameter
loading (experts.py ``load_params``) and command-line entry points against
the JAX package, in f64 on the CPU.

Two JAX programs are compiled, both by the module fixture's two-phase
pipeline: the f64 single-eval fit of four experts and their predict-only
re-run from the smoothed hyperparameters."""

import contextlib
import json
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu import postprocess as JP
from gpsat_tpu.data.store import TableStore as JStore
from gpsat_tpu.experts import LocalExpertOI as JOI
from gpsat_tpu.experts import get_results_from_h5file as jax_results
from gpsat_tpu.models.functional import make_gpr_core as jax_make_gpr_core
from gpsat_tpu.parallel import batching as JB
from gpsat_tpu_torch import cli, postprocess as TP, postprocessing
from gpsat_tpu_torch.experts import LocalExpertOI as TOI
from gpsat_tpu_torch.experts import _bucket_init, core_for, get_results_from_h5file as port_results, initial_cparams

SMOOTH = dict(
    params_to_smooth=["lengthscales", "kernel_variance", "likelihood_variance"],
    smooth_config_dict={
        "lengthscales": {"l_x": 2.0, "l_y": 2.0, "min": 0.3, "max": 4.0},
        "kernel_variance": {"l_x": 2.0, "l_y": 2.0},
        "likelihood_variance": {"l_x": 1.5, "l_y": 2.5, "min": 1e-4},
    },
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under the tier-1 run's six pytest workers torch's
    default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field():
    """600 observations and four experts two apart, whose 3x3 prediction
    stencils (spacing 1) overlap on the lines between them."""
    rng = np.random.default_rng(7)
    n = 600
    x = rng.uniform(0, 10, n)
    y = rng.uniform(0, 10, n)
    obs = np.sin(x / 1.5) * np.cos(y / 2.0) + 0.05 * rng.normal(size=n)
    obs_df = pd.DataFrame({"x": x, "y": y, "obs": obs})
    expert_df = pd.DataFrame({"x": [4.0, 4.0, 6.0, 6.0], "y": [4.0, 6.0, 4.0, 6.0]})
    return obs_df, expert_df


def _config(obs_df, expert_df, **model_extra):
    return dict(
        expert_loc_config={"source": expert_df},
        data_config={
            "data_source": obs_df, "obs_col": "obs", "coords_col": ["x", "y"],
            "local_select": [{"col": ["x", "y"], "comp": "<", "val": 2.0}],
        },
        model_config={
            "oi_model": "GPflowGPRModel",
            "init_params": {"kernel": "Matern32", "noise_variance": 0.01},
            "constraints": {"lengthscales": {"low": 0.1, "high": 20.0}},
            "optim_kwargs": {"max_iter": 300, "linesearch": "single_eval"},
            **model_extra,
        },
        pred_loc_config={"method": "shift_arrays", "x": np.array([-1.0, 0.0, 1.0]), "y": np.array([-1.0, 0.0, 1.0])},
    )


def _pipeline(pkg, store, obs_df, expert_df, fit=True, **run_kw):
    """fit -> smooth -> predict-only re-run -> glue, through one package;
    with fit=False the store holds a fit already."""
    oi_cls, smooth, results = (JOI, JP.smooth_hyperparameters, jax_results) if pkg == "jax" else (
        TOI, TP.smooth_hyperparameters, port_results)
    if fit:
        oi_cls(**_config(obs_df, expert_df)).run(store_path=store, **run_kw)
        shutil.copy(store, store.replace(".h5", "_fit.h5"))
    smooth(result_file=store, save_config_file=False, **SMOOTH, **({"device": "cpu"} if pkg == "port" else {}))
    cfg = _config(obs_df, expert_df, load_params={"file": store, "table_suffix": "_SMOOTHED"})
    oi_cls(**cfg).run(store_path=store, optimise=False, table_suffix="_SMOOTHED",
                      skip_valid_checks_on=["model", "run_kwargs"], **run_kw)
    dfs, _ = results(store, table_suffix="_SMOOTHED")
    glue = JP.glue_local_predictions if pkg == "jax" else TP.glue_local_predictions
    return dfs, glue(dfs["preds_SMOOTHED"], inference_radius=2.0)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    d = tmp_path_factory.mktemp("post")
    obs_df, expert_df = _field()
    jax = _pipeline("jax", str(d / "jax.h5"), obs_df, expert_df)
    port = _pipeline("port", str(d / "port.h5"), obs_df, expert_df, device="cpu", dtype=torch.float64)
    # the port's smoothing, re-run and glue from the JAX package's fit
    shutil.copy(str(d / "jax_fit.h5"), str(d / "port_on_jax_fit.h5"))
    port_after = _pipeline("port", str(d / "port_on_jax_fit.h5"), obs_df, expert_df, fit=False, device="cpu",
                           dtype=torch.float64)
    return {"jax": jax, "port": port, "port_on_jax_fit": port_after, "dir": d, "obs_df": obs_df,
            "expert_df": expert_df}


def _glued_diffs(got, want):
    keys = ["pred_loc_x", "pred_loc_y"]
    got, want = got.sort_values(keys).reset_index(drop=True), want.sort_values(keys).reset_index(drop=True)
    assert len(got) == len(want) == 25  # 4 stencils of 9 overlapping on 25 locations
    np.testing.assert_array_equal(got[keys].to_numpy(), want[keys].to_numpy())
    return {k: float(np.abs(got[k] - want[k]).max()) for k in ("f*", "f*_var", "y_var", "f_bar")}


def test_two_phase_pipeline_matches_jax(pipelines):
    """The whole pipeline through each package. Both f64 fits stop on
    |df| <= 1e-11 |f| at a flat optimum, so one expert of four may stop an
    iteration or two apart (tests/test_torch_engine.py); its parameters then
    sit in the flat optimum's band, and the smoothing spreads that band to
    every glued value: 1e-8 when every expert took the same iterations,
    1e-6 (the engine test's band for such a lane) otherwise."""
    (jdfs, jglued), (pdfs, pglued) = pipelines["jax"], pipelines["port"]
    d = pipelines["dir"]
    jfit, _ = jax_results(str(d / "jax_fit.h5"))
    pfit, _ = port_results(str(d / "port_fit.h5"))
    keys = ["x", "y"]
    iters = jfit["run_details"].merge(pfit["run_details"], on=keys)
    same = (iters["num_iter_x"] == iters["num_iter_y"]).to_numpy()
    assert len(same) == 4 and same.sum() >= 3, iters
    np.testing.assert_allclose(iters["objective_value_x"], iters["objective_value_y"], rtol=1e-10)
    band = 1e-8 if same.all() else 1e-6
    diffs = _glued_diffs(pglued, jglued)
    assert max(diffs.values()) <= band, (diffs, band)
    # the re-run predicted with the smoothed parameters, optimising nothing
    rd = pdfs["run_details_SMOOTHED"]
    assert (rd["num_iter"] == 0).all() and not rd["parameters_optimised"].any()


def test_smooth_repredict_and_glue_of_the_jax_fit_match_jax(pipelines):
    """Everything after the fit, from the same (JAX-written) fit: the port's
    smoothing, predict-only re-run and glue against the JAX package's."""
    diffs = _glued_diffs(pipelines["port_on_jax_fit"][1], pipelines["jax"][1])
    assert max(diffs.values()) <= 1e-8, diffs


def test_predict_only_rerun_skips_the_experts_stored_under_its_suffix(pipelines, tmp_path, capsys):
    store = str(tmp_path / "again.h5")
    shutil.copy(str(pipelines["dir"] / "port.h5"), store)
    cfg = _config(pipelines["obs_df"], pipelines["expert_df"], load_params={"file": store, "table_suffix": "_SMOOTHED"})
    capsys.readouterr()
    TOI(**cfg).run(store_path=store, optimise=False, table_suffix="_SMOOTHED", skip_valid_checks_on=["model", "run_kwargs"],
                   device="cpu", dtype=torch.float64)
    assert "all expert locations already run" in capsys.readouterr().out
    out, _ = port_results(store, table_suffix="_SMOOTHED")
    assert len(out["run_details_SMOOTHED"]) == 4 and len(out["preds_SMOOTHED"]) == 36


def _smoothed_tables(path):
    with JStore(path, mode="r") as store:
        return {k: (store.select(k).reset_index(), store.get_attrs(k)) for k in store.keys() if k.endswith("_SMOOTHED")}


def test_smooth_hyperparameters_on_a_jax_store_matches_jax(pipelines, tmp_path):
    fitted = str(pipelines["dir"] / "jax_fit.h5")
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    shutil.copy(fitted, a)
    shutil.copy(fitted, b)
    cfg_a = JP.smooth_hyperparameters(result_file=a, **SMOOTH)
    cfg_b = TP.smooth_hyperparameters(result_file=b, device="cpu", **SMOOTH)
    want, got = _smoothed_tables(a), _smoothed_tables(b)
    assert sorted(got) == sorted(want) == ["kernel_variance_SMOOTHED", "lengthscales_SMOOTHED",
                                          "likelihood_variance_SMOOTHED"]
    for k in want:
        pd.testing.assert_frame_equal(got[k][0], want[k][0], check_exact=False, rtol=1e-12, atol=0)
        assert got[k][1] == want[k][1], k
    with open(cfg_a) as fa, open(cfg_b) as fb:
        ca, cb = json.load(fa), json.load(fb)
    assert json.dumps(cb).replace(b, a) == json.dumps(ca)
    assert cb[0]["run_kwargs"]["optimise"] is False and cb[0]["model"]["load_params"]["table_suffix"] == "_SMOOTHED"


@pytest.mark.parametrize("case", ["random", "nan_values", "all_nan_target", "constant"])
def test_gaussian_2d_weight_matches_jax(case):
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-5e5, 5e5, 300), rng.uniform(-5e5, 5e5, 300)
    vals = rng.normal(size=300)
    x0, y0 = rng.uniform(-5e5, 5e5, 50), rng.uniform(-5e5, 5e5, 50)
    if case == "nan_values":
        vals[rng.choice(300, 60, replace=False)] = np.nan
    elif case == "all_nan_target":
        vals[:] = np.nan
    elif case == "constant":
        vals[:] = 0.37
    want = JP.gaussian_2d_weight(x0, y0, x, y, 2e5, 1e5, vals)
    got = TP.gaussian_2d_weight(x0, y0, x, y, 2e5, 1e5, vals, device="cpu")
    assert got.dtype == np.float64 and got.shape == (50,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if case == "all_nan_target":
        assert np.isnan(got).all()
    if case == "constant":
        np.testing.assert_allclose(got, 0.37, rtol=1e-12)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.gaussian_2d_weight([0.0], [0.0], [0.0], [0.0], 1.0, 1.0, [1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.smooth_table(pd.DataFrame({"x": [0.0], "y": [0.0], "_dim_0": [0], "v": [1.0]}), "v", ["x", "y"], ["x", "y"],
                        TP.SmoothingConfig())


def _expert_batch(expert_df, rows):
    """A JAX TileBatch carrying just the expert rows (and one dead tile)."""
    e = np.r_[rows, -1]
    z = np.zeros((len(e), 1))
    return JB.TileBatch(X=z[..., None], y=z, mask=z, Xnew=z[..., None], pred_mask=z, obs_mean=z[:, 0],
                        expert_index=e, num_obs=np.zeros(len(e), dtype=int))


@pytest.mark.parametrize("case", ["file", "nearest", "direct", "previous", "nan_rows", "missing_file"])
def test_load_params_matches_jax(pipelines, tmp_path, case):
    """The per-expert initial params of a bucket from ``load_params``:
    the port's store read and ``sweep`` rows against JAX's
    ``_load_params_for_batch``."""
    store = str(tmp_path / "fit.h5")
    shutil.copy(str(pipelines["dir"] / "port_fit.h5"), store)
    expert_df = pipelines["expert_df"].copy()
    lp = {"file": store}
    if case == "nearest":
        expert_df["x"] += np.array([0.3, -0.2, 0.1, 0.4])  # no exact match: the closest stored expert
        lp["nearest"] = True
    elif case == "direct":
        lp = {"lengthscales": [2.0, 3.0], "likelihood_variance": 0.05}
    elif case == "previous":
        lp = {"previous": True}
    elif case == "nan_rows":
        with JStore(store) as s:
            t = s.select("lengthscales").reset_index()
            t.loc[(t["x"] == 6.0) & (t["y"] == 4.0) & (t["_dim_0"] == 1), "lengthscales"] = np.nan
            s.put("lengthscales", t.set_index(["x", "y"]))
    elif case == "missing_file":
        lp = {"file": str(tmp_path / "nowhere.h5")}
    cfg = _config(pipelines["obs_df"], expert_df, load_params=lp)
    cfg["model_config"]["init_params"]["smart_init"] = True
    coords = ["x", "y"]
    rows = np.array([2, 0, 3, 1])

    joi = JOI(**cfg)
    jcore = jax_make_gpr_core()
    jinit = joi._initial_cparams(jcore, joi.model_init_params)
    def warns():
        return pytest.warns(UserWarning, match="does not exist") if case == "missing_file" else contextlib.nullcontext()

    with warns():
        want = joi._load_params_for_batch(_expert_batch(expert_df, rows), expert_df, coords, jinit, jcore, store, "")

    toi = TOI(**cfg)
    tcore = core_for(toi.model_init_params, toi.constraints)
    tinit = initial_cparams(tcore, toi.model_init_params, toi.constraints, 2)
    with warns():
        loaded = toi._load_params_for_experts(expert_df, coords, tinit, tcore, store)
    if case == "missing_file":
        assert want is None and loaded is False
        return
    got = _bucket_init(tinit, loaded, np.r_[rows, -1])
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    live = slice(0, len(rows))  # the dead tile's row reaches no result
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.ndim > np.ndim(tinit[k]):
            g, w = g[live], (w[live] if w.ndim > np.ndim(tinit[k]) else w)
        np.testing.assert_array_equal(g, np.broadcast_to(w, g.shape), err_msg=k)
    if case in ("file", "nearest", "nan_rows"):
        assert np.asarray(got["lengthscales"]).shape == (5, 2) and "smart_init" not in got
    if case == "nan_rows":  # expert (6, 4) is row 2: its lengthscales keep the shared init
        np.testing.assert_array_equal(got["lengthscales"][0], tinit["lengthscales"])
        assert not np.array_equal(got["lengthscales"][1], tinit["lengthscales"])


def test_read_params_for_loc_matches_jax(pipelines):
    store = str(pipelines["dir"] / "port_fit.h5")
    expert_df = pipelines["expert_df"]
    cfg = _config(pipelines["obs_df"], expert_df)
    ref_loc = {"x": 6.0, "y": 4.0}

    class Model:
        param_names = ["lengthscales", "kernel_variance", "likelihood_variance"]

        def set_parameters(self, **kw):
            self.params = kw

    want = JOI(**cfg)._read_params_for_loc(store, Model(), ref_loc)
    got = TOI(**cfg)._read_params_for_loc(store, Model(), ref_loc)
    assert got.keys() == want.keys() == set(Model.param_names)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    m = Model()
    assert TOI(**cfg).load_params(m, file=store, ref_loc=pd.DataFrame([ref_loc])) == 0
    assert m.params.keys() == want.keys()
    assert TOI(**cfg).load_params(m, file=store, ref_loc=pd.DataFrame([{"x": -1.0, "y": -1.0}])) == 1


@pytest.mark.parametrize("dims", [1, 2])
def test_glue_matches_jax(dims):
    rng = np.random.default_rng(dims)
    n = 400
    preds = pd.DataFrame({"x": rng.choice([0.0, 2.0, 4.0], n), "y": rng.choice([0.0, 2.0], n)})
    preds["pred_loc_x"] = preds["x"] + rng.choice([-1.0, 0.0, 1.0], n)
    preds["pred_loc_y"] = preds["y"] + rng.choice([-1.0, 0.0, 1.0], n)
    for k in ("f*", "f*_var", "y_var", "f_bar"):
        preds[k] = rng.normal(size=n)
    if dims == 1:
        radius = {0.0: 2.0, 2.0: 3.0, 4.0: 2.5}
        want = JP.glue_local_predictions_1d(preds, "pred_loc_x", "x", "f*", radius, R=3)
        got = TP.glue_local_predictions_1d(preds, "pred_loc_x", "x", "f*", radius, R=3)
    else:
        want = JP.glue_local_predictions(preds, inference_radius=2.0)
        got = TP.glue_local_predictions(preds, inference_radius=2.0)
        assert "f_bar" in got.columns
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12, atol=0)


# the last two cases keep the ids they had while xval and prime_cache were stubs
@pytest.mark.parametrize("argv, rc", [(["--help"], 0), ([], 2), (["no_such_command"], 2), (["read_and_store"], 2),
                                      (["bin_data"], 2), pytest.param(["xval", "--help"], 0, id="argv5-1"),
                                      pytest.param(["prime_cache", "--help"], 0, id="argv6-1")])
def test_cli_dispatcher(argv, rc, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", list(sys.argv))  # the dispatcher rewrites it for the command
    assert cli.main(argv) == rc
    out, err = capsys.readouterr()
    if argv[:1] in (["read_and_store"], ["bin_data"]):  # ported: run without a config, the usage error
        assert f"usage: python -m gpsat_tpu_torch.{argv[0]} <config.json>" in err
    if argv[:1] in (["xval"], ["prime_cache"]):
        assert f"python -m gpsat_tpu_torch.cli {argv[0]}" in out
    if argv == ["--help"]:
        assert all(c in out for c in ("local_expert_oi", "postprocessing", "xval", "prime_cache"))


def test_postprocessing_cli_smooths_a_store(pipelines, tmp_path, monkeypatch):
    store = str(tmp_path / "cli.h5")
    shutil.copy(str(pipelines["dir"] / "port_fit.h5"), store)
    cfg_path = tmp_path / "post.json"
    cfg_path.write_text(json.dumps({"comment": "smooth", "result_file": store, "device": "cpu", **SMOOTH}))
    monkeypatch.setattr(sys, "argv", ["gpsat_tpu_torch.cli", "postprocessing", str(cfg_path)])
    assert cli.main() == 0
    assert sys.argv == ["gpsat_tpu_torch.cli postprocessing", str(cfg_path)]
    with open(store.replace(".h5", "_SMOOTHED.json")) as f:
        out = json.load(f)
    assert out[0]["run_kwargs"]["optimise"] is False
    assert set(_smoothed_tables(store)) == {"lengthscales_SMOOTHED", "kernel_variance_SMOOTHED",
                                            "likelihood_variance_SMOOTHED"}
    assert postprocessing.smooth_hyperparameters is TP.smooth_hyperparameters
