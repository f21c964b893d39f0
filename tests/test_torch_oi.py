"""The port's orchestrator (gpsat_tpu_torch/experts.py, the exact-GPR lane)
and its f64 polish against the JAX package, on the CPU.

Two JAX programs are compiled: one module-scoped ``LocalExpertOI`` run in
f64 with the single-eval search (the same algorithm as the port's), and one
f64 zoom gold runner at the shapes of ``tests/test_accuracy_northstar.py``
(B=8, N=128, P=32), which serves both polish tests."""

import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.data.store import TableStore as JStore
from gpsat_tpu.experts import LocalExpertOI as JOI
from gpsat_tpu.experts import get_results_from_h5file as jax_results
from gpsat_tpu.models.functional import make_gpr_core as jax_make_gpr_core
from gpsat_tpu.parallel import batching as JB
from gpsat_tpu.parallel import engine as JE
from gpsat_tpu_torch import local_expert_oi
from gpsat_tpu_torch.experts import LocalExpertOI as TOI
from gpsat_tpu_torch.experts import get_results_from_h5file as port_results
from gpsat_tpu_torch.models import get_model
from gpsat_tpu_torch.models.functional import make_gpr_core
from gpsat_tpu_torch.parallel import batching as TB
from gpsat_tpu_torch.parallel import engine as TE

TABLES = ["expert_locs", "kernel_variance", "lengthscales", "likelihood_variance", "preds", "run_details"]
GOLD_SHAPES = (8, 128, 32)  # B, N, P of the zoom gold program


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


def _field():
    """The synthetic field and 2x2 expert grid of tests/test_experts_oi.py."""
    rng = np.random.default_rng(11)
    n = 500
    x = rng.uniform(0, 10, n)
    y = rng.uniform(0, 10, n)
    t = rng.integers(0, 3, n).astype(float)
    obs = np.sin(x) * np.cos(y) + 0.1 * rng.normal(size=n)
    obs_df = pd.DataFrame({"x": x, "y": y, "t": t, "obs": obs})
    expert_df = pd.DataFrame({"x": [3.0, 3.0, 7.0, 7.0], "y": [3.0, 7.0, 3.0, 7.0], "t": [1.0, 1.0, 1.0, 1.0]})
    return obs_df, expert_df


def _config(obs_df, expert_df, **model_extra):
    return dict(
        expert_loc_config={"source": expert_df},
        data_config={
            "data_source": obs_df,
            "obs_col": "obs",
            "coords_col": ["x", "y", "t"],
            "local_select": [
                {"col": ["x", "y"], "comp": "<", "val": 4.0},
                {"col": "t", "comp": "<=", "val": 1.0},
                {"col": "t", "comp": ">=", "val": -1.0},
            ],
        },
        model_config={
            "oi_model": "GPflowGPRModel",
            "init_params": {"kernel": "Matern32", "noise_variance": 0.01},
            "constraints": {"lengthscales": {"low": 0.1, "high": 20.0}},
            "optim_kwargs": {"max_iter": 300, "linesearch": "single_eval"},
            **model_extra,
        },
        pred_loc_config={"method": "shift_arrays", "x": np.array([-0.5, 0.0, 0.5]), "y": np.array([0.0])},
    )


def _port_run(store, obs_df, expert_df, **model_extra):
    TOI(**_config(obs_df, expert_df, **model_extra)).run(store_path=store, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same config through both packages, both in f64 with the
    single-eval search: the JAX store, the port's store and the data."""
    d = tmp_path_factory.mktemp("oi")
    obs_df, expert_df = _field()
    JOI(**_config(obs_df, expert_df)).run(store_path=str(d / "jax.h5"))
    _port_run(str(d / "port.h5"), obs_df, expert_df)
    return str(d / "jax.h5"), str(d / "port.h5"), obs_df, expert_df


def _sorted(df):
    keys = [c for c in ("x", "y", "t", "_dim_0") if c in df.columns]
    return df.sort_values(keys).reset_index(drop=True)


def test_orchestrator_f64_tables_match_jax(stores):
    jax_path, port_path, _, _ = stores
    with JStore(jax_path, mode="r") as js, JStore(port_path, mode="r") as ps:
        assert js.keys() == ps.keys() == sorted(["oi_config"] + TABLES)
        for t in TABLES:
            a, b = js.select(t), ps.select(t)
            assert list(a.columns) == list(b.columns), t
            assert list(a.index.names) == list(b.index.names) == ["x", "y", "t"], t
            assert (a.dtypes == b.dtypes).all(), (t, a.dtypes, b.dtypes)
            assert len(a) == len(b), t
        # the stored configs differ only in run_kwargs (the store paths), so
        # a rerun of either package matches the other's config_id
        jc, pc = (json.loads(s.select("oi_config", set_index=False)["config"][0]) for s in (js, ps))
        assert jc.pop("run_kwargs")["store_path"] != pc.pop("run_kwargs")["store_path"]
        assert jc == pc
    J, _ = jax_results(jax_path)
    P, _ = port_results(port_path)
    jp, pp = _sorted(J["preds"]), _sorted(P["preds"])
    for c in ("x", "y", "t", "_dim_0", "f_bar", "pred_loc_x", "pred_loc_y", "pred_loc_t"):
        np.testing.assert_array_equal(pp[c], jp[c], err_msg=c)
    # the same f64 single-eval fit in another summation order: both stop on
    # |df| <= 1e-11 |f| near a flat optimum, an iteration or a few apart
    for c in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(pp[c], jp[c], rtol=0, atol=1e-6, err_msg=c)
    for t in ("lengthscales", "kernel_variance", "likelihood_variance"):
        a, b = _sorted(J[t]), _sorted(P[t])
        np.testing.assert_allclose(b[t], a[t], rtol=1e-4, err_msg=t)
    jr, pr = _sorted(J["run_details"]), _sorted(P["run_details"])
    np.testing.assert_array_equal(pr["num_obs"], jr["num_obs"])
    assert pr["optimise_success"].all() and jr["optimise_success"].all()
    np.testing.assert_allclose(pr["objective_value"], jr["objective_value"], rtol=1e-8)
    assert (pr["device"] == "cpu").all() and (pr["model"] == "gpsat_tpu_torch.GPRModel").all()


def test_port_store_reads_through_the_jax_reader(stores):
    _, port_path, _, _ = stores
    J, jcfg = jax_results(port_path)
    P, pcfg = port_results(port_path)
    assert sorted(J) == sorted(P) and jcfg == pcfg
    for k in J:
        pd.testing.assert_frame_equal(J[k], P[k])


def test_rerun_on_a_jax_store_skips_every_expert(stores, tmp_path, capsys):
    jax_path, _, obs_df, expert_df = stores
    path = str(tmp_path / "copy.h5")
    shutil.copy(jax_path, path)
    with JStore(path, mode="r") as s:
        before = {t: len(s.select(t)) for t in TABLES}
    _port_run(path, obs_df, expert_df)
    assert "nothing to do" in capsys.readouterr().out
    with JStore(path, mode="r") as s:
        assert {t: len(s.select(t)) for t in TABLES} == before
        assert len(s.select("oi_config", set_index=False)) == 1


def test_incompatible_config_raises(stores, tmp_path):
    jax_path, _, obs_df, expert_df = stores
    path = str(tmp_path / "copy.h5")
    shutil.copy(jax_path, path)
    with pytest.raises(AssertionError, match="differs from the previously stored"):
        _port_run(path, obs_df, expert_df, init_params={"kernel": "Matern52", "noise_variance": 0.01})


@pytest.fixture(scope="module")
def gold_runner():
    """The f64 zoom gold of tests/test_accuracy_northstar.py (jitter 0,
    tol_grad 1e-6, tol_f 1e-11), one JAX program for both polish tests."""
    core = jax_make_gpr_core(jitter=0.0)
    runner = JE.make_batched_runner(core, max_iter=200, linesearch="zoom", tol_grad=1e-6, tol_f=1e-11)

    def gold(batch, init):
        assert (batch.B, batch.Nmax, batch.Pmax) == GOLD_SHAPES
        res = JE.run_tile_batch(batch, init, runner, core)
        assert np.asarray(res["converged"]).all()
        return res

    return gold


def _northstar_batch():
    """tests/test_accuracy_northstar.py's batch and init (seed 0)."""
    B, N, P = GOLD_SHAPES
    rng = np.random.default_rng(0)
    X = rng.uniform(-6, 6, size=(B, N, 2))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))
    mask = np.ones((B, N))
    fill = rng.integers(int(0.6 * N), N + 1, size=B)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    Xnew = rng.uniform(-4, 4, size=(B, P, 2))
    batch = JB.TileBatch(
        X=X, y=y, mask=mask, Xnew=Xnew, pred_mask=np.ones((B, P)), obs_mean=np.zeros(B),
        expert_index=np.arange(B), num_obs=fill,
    )
    var_y = np.nanvar(np.where(mask > 0, y, np.nan), axis=1)
    init = {
        "lengthscales": np.nanstd(np.where(mask[..., None] > 0, X, np.nan), axis=1),
        "kernel_variance": var_y,
        "likelihood_variance": 0.1 * var_y,
    }
    return batch, init


def test_polish_tile_batch_meets_the_f64_gold(gold_runner):
    # f32 fit in the port (jitter 1e-5, single-eval), then the port's polish
    # from those optima (its defaults but max_iter 100, as the JAX test):
    # within the north star's 1e-5 of the JAX f64 zoom gold
    batch, init = _northstar_batch()
    gold = gold_runner(batch, init)
    tbatch = TB.TileBatch(**{f: getattr(batch, f) for f in ("X", "y", "mask", "Xnew", "pred_mask", "obs_mean",
                                                            "expert_index", "num_obs")})
    core = make_gpr_core(jitter=1e-5)
    runner = TE.make_batched_runner(core, max_iter=200, linesearch="single_eval", tol_grad=1e-3, tol_f=1e-6,
                                    device="cpu")
    res32 = TE.run_tile_batch(TB.cast_batch(tbatch, np.float32), {k: v.astype(np.float32) for k, v in init.items()},
                              runner, core, device="cpu")
    assert res32["converged"].all() and res32["f_mean"].dtype == np.float32
    polished = TE.polish_tile_batch(tbatch, res32, jitter=0.0, max_iter=100, device="cpu")
    assert polished["f_mean"].dtype == np.float64
    np.testing.assert_array_equal(polished["expert_index"], gold["expert_index"])
    for k in ("f_mean", "f_var"):
        err = float(np.abs(polished[k] - gold[k]).max())
        assert err <= 1e-5, (k, err)
    # the raw f32 pass stays in its own band
    assert float(np.abs(res32["f_mean"] - gold["f_mean"]).max()) <= 5e-2


def test_default_f64_fit_meets_the_zoom_gold(gold_runner):
    # the port's f64 runner with no line search named takes the JAX
    # engine's f64 default, zoom: within the north star's 1e-5 of the gold
    batch, init = _northstar_batch()
    gold = gold_runner(batch, init)
    tbatch = TB.TileBatch(**{f: getattr(batch, f) for f in ("X", "y", "mask", "Xnew", "pred_mask", "obs_mean",
                                                            "expert_index", "num_obs")})
    core = make_gpr_core(jitter=0.0)
    runner = TE.make_batched_runner(core, max_iter=200, tol_grad=1e-6, tol_f=1e-11, device="cpu")
    res = TE.run_tile_batch(tbatch, init, runner, core, device="cpu")
    assert res["converged"].all()
    for k in ("f_mean", "f_var"):
        err = float(np.abs(res[k] - gold[k]).max())
        assert err <= 1e-5, (k, err)


def test_polish_aligns_the_coarse_result_by_expert_index():
    # a coalesced split padded with dead tiles, and a coarse result in another
    # row order: the polish pairs each tile with its own expert's optimum
    batch, init = _northstar_batch()
    tbatch = TB.pad_batch_to(TB.TileBatch(**{f: getattr(batch, f)[:3] for f in (
        "X", "y", "mask", "Xnew", "pred_mask", "obs_mean", "expert_index", "num_obs")}), 4)
    coarse = {"expert_index": np.array([2, 0, 1]), **{k: v[[2, 0, 1]] for k, v in init.items()}}
    core = make_gpr_core()
    got = TE.polish_tile_batch(tbatch, coarse, core, max_iter=0, device="cpu")
    np.testing.assert_array_equal(got["expert_index"], [0, 1, 2])
    for k, v in init.items():
        np.testing.assert_allclose(got[k], v[:3], rtol=1e-12)
    with pytest.raises(ValueError, match="no row"):
        TE.polish_tile_batch(tbatch, {k: v[:2] for k, v in coarse.items()}, core, max_iter=0, device="cpu")


def test_polish_through_the_orchestrator_meets_the_f64_gold(gold_runner, tmp_path):
    # tests/test_experts_oi.py's polish setup (seed 3, sin*cos field, 0.05
    # noise, a 4.0 radius, predictions at the expert) with 120 points and 8
    # experts, so that every tile is one bucket of the gold program's shape
    rng = np.random.default_rng(3)
    n = 120
    df = pd.DataFrame({"x": rng.uniform(-3, 3, n), "y": rng.uniform(-3, 3, n)})
    df["obs"] = np.sin(df["x"]) * np.cos(df["y"]) + 0.05 * rng.normal(size=n)
    experts = pd.DataFrame({"x": [-1.0, 0.0, 1.0, 2.0] * 2, "y": [-0.5] * 4 + [0.5] * 4})
    local_select = [{"col": ["x", "y"], "comp": "<", "val": 4.0}]
    oi = TOI(
        expert_loc_config={"source": experts},
        data_config={"data_source": df, "obs_col": "obs", "coords_col": ["x", "y"], "local_select": local_select},
        model_config={"oi_model": "GPflowGPRModel", "init_params": {"noise_variance": 0.0025},
                      "optim_kwargs": {"max_iter": 200, "polish": "f64", "polish_max_iter": 150}},
        pred_loc_config={"method": "expert_loc"},
    )
    path = str(tmp_path / "oi.h5")
    oi.run(store_path=path, device="cpu")
    assert oi.phase_timers["polish"] > 0
    with JStore(path, mode="r") as s:
        rd = s.select("run_details", set_index=False)
        pr = s.select("preds", set_index=False)
    assert rd["optimise_success"].all() and pr["f*"].dtype == np.float64

    # the gold: the same tiles (the JAX package's assembly, padded to the
    # gold program's P), each expert's f64 zoom optimum and prediction
    from gpsat_tpu.data import select as JS

    ix = JS.local_select_indices_all(df, experts, local_select)
    tiles = JB.assemble_tiles(df[["x", "y"]].values, df["obs"].values, ix, [experts.values[[e]] for e in range(8)])
    (b,) = tiles
    P = GOLD_SHAPES[2]
    pad = P - b.Pmax
    b = JB.TileBatch(**{**b.__dict__, "Xnew": np.pad(b.Xnew, ((0, 0), (0, pad), (0, 0))),
                        "pred_mask": np.pad(b.pred_mask, ((0, 0), (0, pad)))})
    gold = gold_runner(b, {"smart_init": True})
    want = pd.DataFrame({"x": experts["x"].values[gold["expert_index"]], "y": experts["y"].values[gold["expert_index"]],
                         "f": gold["f_mean"][:, 0], "v": gold["f_var"][:, 0]})
    got = pr.merge(want, on=["x", "y"])
    assert len(got) == 8
    np.testing.assert_allclose(got["f*"], got["f"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["f*_var"], got["v"], rtol=0, atol=1e-5)


def test_cli_main_runs_a_config_on_the_cpu(tmp_path):
    obs_df, expert_df = _field()
    cfg = _config(obs_df, expert_df.iloc[:2])
    path = str(tmp_path / "cli.h5")
    local_expert_oi.main({
        "comment": "two experts", "locations": cfg["expert_loc_config"], "data": cfg["data_config"],
        "model": {**cfg["model_config"], "optim_kwargs": {"max_iter": 15}}, "pred_loc": cfg["pred_loc_config"],
        "run_kwargs": {"store_path": path, "device": "cpu", "dtype": "float32", "min_obs": 10},
    })
    out, configs = port_results(path)
    assert len(out["run_details"]) == 2 and len(out["preds"]) == 6
    assert out["preds"]["f*"].dtype == np.float32 and np.isfinite(out["preds"]["f*"]).all()
    assert "device" not in configs[0]["run_kwargs"] and "dtype" not in configs[0]["run_kwargs"]


@pytest.mark.parametrize(
    "model_extra, run_kwargs",
    [
        # the mesh is ported; a mesh that mixes the CPU and a card is refused
        ({}, {"mesh": ["cpu", "cuda:0"]}),
    ],
    ids=["mesh"],
)
def test_unported_options_raise(model_extra, run_kwargs, tmp_path):
    obs_df, expert_df = _field()
    path = tmp_path / "never.h5"
    with pytest.raises(ValueError, match="mixes"):
        TOI(**_config(obs_df, expert_df, **model_extra)).run(store_path=str(path), device="cpu", **run_kwargs)
    assert not path.exists()


@pytest.mark.parametrize(
    "model_extra, run_kwargs",
    [
        # an SVGP replacement lane, an SGPR and an SVGP lane, and f64 fits
        # that name no line search (the zoom default)
        ({"replacement_threshold": 1000, "replacement_model": "GPflowSVGPModel",
          "replacement_init_params": {"num_inducing_points": 8, "noise_variance": 0.01}}, {}),
        ({"oi_model": "GPflowSGPRModel", "init_params": {"num_inducing_points": 8, "noise_variance": 0.01},
          "optim_kwargs": {"max_iter": 5}}, {"dtype": torch.float64}),
        ({"oi_model": "GPflowSVGPModel", "init_params": {"num_inducing_points": 8, "noise_variance": 0.01},
          "optim_kwargs": {"max_iter": 5}}, {}),
        ({"optim_kwargs": {"max_iter": 5}}, {"dtype": torch.float64}),
        # the inter-domain lanes, on their own and as replacement lanes (3-d
        # coordinates: 27 features each)
        ({"replacement_threshold": 1000, "replacement_model": "GPflowVFFModel",
          "replacement_init_params": {"num_inducing_features": 2, "noise_variance": 0.01},
          "replacement_optim_kwargs": {"max_iter": 5}}, {}),
        ({"oi_model": "GPflowSGPRModel", "init_params": {"num_inducing_points": 8, "noise_variance": 0.01},
          "replacement_threshold": 1000, "replacement_model": "GPflowASVGPModel",
          "replacement_init_params": {"num_inducing_features": 3, "noise_variance": 0.01},
          "replacement_optim_kwargs": {"max_iter": 5}}, {}),
        ({"oi_model": "GPflowVFFModel", "init_params": {"num_inducing_features": 2, "noise_variance": 0.01},
          "optim_kwargs": {"max_iter": 5}}, {}),
        ({"oi_model": "GPflowASVGPModel", "init_params": {"num_inducing_features": 3, "noise_variance": 0.01},
          "optim_kwargs": {"max_iter": 5}}, {}),
        # the host-serial lane, and a run traced under profile_dir
        ({"oi_model": "sklearnGPRModel", "init_params": {"noise_variance": 0.01}}, {}),
        ({"optim_kwargs": {"max_iter": 5}}, {"profile_dir": "trace"}),
    ],
    ids=["svgp_replacement", "sgpr_f64_default", "svgp", "f64_without_linesearch", "replacement_vff",
         "sgpr_replacement_asvgp", "vff", "asvgp", "host_lane", "profile_dir"],
)
def test_options_that_were_not_ported_run(model_extra, run_kwargs, tmp_path):
    obs_df, expert_df = _field()
    path = str(tmp_path / "ran.h5")
    if "profile_dir" in run_kwargs:
        run_kwargs = {"profile_dir": str(tmp_path / run_kwargs["profile_dir"])}
    TOI(**_config(obs_df, expert_df.iloc[:2], **model_extra)).run(store_path=path, device="cpu", min_obs=10,
                                                                   **run_kwargs)
    out, _ = port_results(path)
    assert len(out["run_details"]) == 2 and np.isfinite(out["preds"]["f*"]).all()
    # every expert ran in the lane the config sends it to
    lane = model_extra.get("replacement_model") if "replacement_threshold" in model_extra else None
    lane = get_model(lane or model_extra.get("oi_model", "GPflowGPRModel"))
    assert set(out["run_details"]["model"]) == {f"gpsat_tpu_torch.{lane.__name__}"}
    if "profile_dir" in run_kwargs:
        assert list((tmp_path / "trace").glob("*.pt.trace.json"))
