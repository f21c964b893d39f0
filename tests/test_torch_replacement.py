"""The port's orchestrator with two model lanes, against the JAX package on
the CPU: SGPR for the data-rich experts, exact GPR as the replacement model
for the experts with fewer observations than ``replacement_threshold``.

Two JAX programs are compiled, one per lane (the module-scoped
``LocalExpertOI`` run in f64 with the single-eval search). The SGPR example
config also runs through ``python -m gpsat_tpu_torch.cli local_expert_oi``
on a temporary store."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.experts import LocalExpertOI as JOI
from gpsat_tpu.experts import get_results_from_h5file as jax_results
from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.experts import LocalExpertOI as TOI
from gpsat_tpu_torch.experts import get_results_from_h5file as port_results
from gpsat_tpu_torch.experts import sweep
from gpsat_tpu_torch.parallel import batching as TB

REPO = Path(__file__).resolve().parent.parent
THRESHOLD = 100
M = 16
TABLES = ["expert_locs", "inducing_points", "kernel_variance", "lengthscales", "likelihood_variance", "preds",
          "run_details"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_oi.py: six pytest workers
    share the machine's cores in the tier-1 run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field():
    """500 points on [0, 10]^2; experts near the corners see fewer than
    THRESHOLD observations within the radius, those inside more."""
    rng = np.random.default_rng(11)
    n = 500
    x, y = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
    obs = np.sin(x) * np.cos(y) + 0.1 * rng.normal(size=n)
    obs_df = pd.DataFrame({"x": x, "y": y, "obs": obs})
    expert_df = pd.DataFrame({"x": [1.0, 5.0, 9.0, 5.0, 4.0], "y": [1.0, 5.0, 1.0, 9.5, 4.0]})
    return obs_df, expert_df


def _config(obs_df, expert_df, **model_extra):
    single = {"max_iter": 300, "linesearch": "single_eval"}
    return dict(
        expert_loc_config={"source": expert_df},
        data_config={"data_source": obs_df, "obs_col": "obs", "coords_col": ["x", "y"],
                     "local_select": [{"col": ["x", "y"], "comp": "<", "val": 3.0}]},
        model_config={
            "oi_model": "GPflowSGPRModel",
            "init_params": {"kernel": "Matern32", "noise_variance": 0.01, "num_inducing_points": M},
            "constraints": {"lengthscales": {"low": 0.1, "high": 20.0}},
            "optim_kwargs": single,
            "replacement_threshold": THRESHOLD,
            "replacement_model": "GPflowGPRModel",
            "replacement_optim_kwargs": single,
            **model_extra,
        },
        pred_loc_config={"method": "shift_arrays", "x": np.array([-0.5, 0.0, 0.5]), "y": np.array([0.0])},
    )


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    d = tmp_path_factory.mktemp("replacement")
    obs_df, expert_df = _field()
    JOI(**_config(obs_df, expert_df)).run(store_path=str(d / "jax.h5"))
    TOI(**_config(obs_df, expert_df)).run(store_path=str(d / "port.h5"), device="cpu", dtype=torch.float64)
    J, _ = jax_results(str(d / "jax.h5"))
    P, _ = port_results(str(d / "port.h5"))
    return str(d / "jax.h5"), str(d / "port.h5"), J, P


def _sorted(df):
    keys = [c for c in ("x", "y", "_dim_0", "_dim_1") if c in df.columns]
    return df.sort_values(keys).reset_index(drop=True)


def test_both_lanes_ran_and_each_expert_took_the_lane_its_count_says(stores):
    _, _, J, P = stores
    for R in (J, P):
        rd = R["run_details"]
        big = rd["num_obs"] >= THRESHOLD
        assert big.any() and (~big).any()
    rd = P["run_details"]
    assert (rd.loc[rd["num_obs"] >= THRESHOLD, "model"] == "gpsat_tpu_torch.SGPRModel").all()
    assert (rd.loc[rd["num_obs"] < THRESHOLD, "model"] == "gpsat_tpu_torch.GPRModel").all()
    jrd = J["run_details"]
    assert (jrd.loc[jrd["num_obs"] >= THRESHOLD, "model"] == "gpsat_tpu.SGPRModel").all()
    # only the SGPR lane stores inducing points: M x D rows per expert
    ip = P["inducing_points"]
    assert len(ip) == int((rd["num_obs"] >= THRESHOLD).sum()) * M * 2
    assert sorted(ip.columns[:4]) == ["_dim_0", "_dim_1", "x", "y"]


def test_tables_match_jax(stores):
    jax_path, port_path, J, P = stores
    with TableStore(jax_path, mode="r") as js, TableStore(port_path, mode="r") as ps:
        assert js.keys() == ps.keys() == sorted(["oi_config"] + TABLES)
        for t in TABLES:
            a, b = js.select(t), ps.select(t)
            assert list(a.columns) == list(b.columns), t
            assert list(a.index.names) == list(b.index.names) == ["x", "y"], t
            assert (a.dtypes == b.dtypes).all(), t
            assert len(a) == len(b), t
    jp, pp = _sorted(J["preds"]), _sorted(P["preds"])
    for c in ("x", "y", "_dim_0", "f_bar", "pred_loc_x", "pred_loc_y"):
        np.testing.assert_array_equal(pp[c], jp[c], err_msg=c)
    for c in ("f*", "f*_var", "y_var"):
        np.testing.assert_allclose(pp[c], jp[c], rtol=0, atol=1e-6, err_msg=c)
    # the inducing points are drawn, not fitted: the same numbers
    np.testing.assert_array_equal(_sorted(P["inducing_points"])["inducing_points"],
                                  _sorted(J["inducing_points"])["inducing_points"])
    for t in ("lengthscales", "kernel_variance", "likelihood_variance"):
        np.testing.assert_allclose(_sorted(P[t])[t], _sorted(J[t])[t], rtol=1e-4, err_msg=t)
    jr, pr = _sorted(J["run_details"]), _sorted(P["run_details"])
    np.testing.assert_array_equal(pr["num_obs"], jr["num_obs"])
    assert pr["optimise_success"].all() and jr["optimise_success"].all()
    np.testing.assert_allclose(pr["objective_value"], jr["objective_value"], rtol=1e-8)


def test_load_params_carries_the_inducing_points(stores, tmp_path):
    """A predict-only re-run that loads every lane's parameters from the
    store, the [M, D] inducing points included, predicts what the fit did
    and stores the loaded inducing points again."""
    _, port_path, _, P = stores
    path = str(tmp_path / "copy.h5")
    shutil.copy(port_path, path)
    obs_df, expert_df = _field()
    TOI(**_config(obs_df, expert_df, load_params={"file": port_path})).run(
        store_path=path, optimise=False, table_suffix="_re", device="cpu", dtype=torch.float64)
    with TableStore(path, mode="r") as s:
        re = {t: s.select(f"{t}_re").reset_index() for t in ("preds", "inducing_points", "run_details")}
    assert (re["run_details"]["num_iter"] == 0).all()
    np.testing.assert_array_equal(_sorted(re["inducing_points"])["inducing_points"],
                                  _sorted(P["inducing_points"])["inducing_points"])
    for c in ("f*", "f*_var"):
        np.testing.assert_allclose(_sorted(re["preds"])[c], _sorted(P["preds"])[c], rtol=0, atol=1e-9, err_msg=c)


def _sweep(obs_df, expert_df, **kw):
    cfg = _config(obs_df, expert_df)
    mc, dc = cfg["model_config"], cfg["data_config"]
    args = dict(
        coords_col=dc["coords_col"], obs_col="obs", local_select=dc["local_select"],
        pred_loc=PredictionLocations(coords_col=dc["coords_col"], **cfg["pred_loc_config"]),
        model=mc["oi_model"], init_params=mc["init_params"], constraints=mc["constraints"],
        optim_kwargs={**mc["optim_kwargs"], "max_iter": 20}, dtype=torch.float64, device="cpu",
    )
    return [r for r in sweep(obs_df, expert_df, **{**args, **kw}) if not r.get("skipped")]


def test_sweep_lanes_equal_sweeps_of_each_lanes_experts_alone():
    obs_df, expert_df = _field()
    lanes = _sweep(obs_df, expert_df, replacement_threshold=THRESHOLD, replacement_model="GPflowGPRModel",
                   replacement_optim_kwargs={"max_iter": 20, "linesearch": "single_eval"})
    assert [r["lane"] for r in lanes] == ["main", "replacement"]
    assert [r["model"] for r in lanes] == ["SGPRModel", "GPRModel"]
    for r, model in zip(lanes, ("GPflowSGPRModel", "GPflowGPRModel")):
        rows = np.sort(r["expert_index"])
        (alone,) = _sweep(obs_df, expert_df.iloc[rows].reset_index(drop=True), model=model)
        # the same tiles in the same bucket order: the same numbers
        np.testing.assert_array_equal(rows[alone["expert_index"]], r["expert_index"])
        for k in ("f_mean", "f_var"):
            np.testing.assert_array_equal(alone[k], r[k])


def test_polish_takes_each_lanes_own_core():
    obs_df, expert_df = _field()
    out = _sweep(obs_df, expert_df, optim_kwargs={"max_iter": 20, "linesearch": "single_eval", "polish": "f64",
                                                  "polish_max_iter": 5},
                 replacement_threshold=THRESHOLD, replacement_model="GPflowGPRModel",
                 replacement_optim_kwargs={"max_iter": 20, "linesearch": "single_eval"})
    main, repl = out
    # the SGPR polish keeps the fixed inducing points; the GPR polish has none
    np.testing.assert_array_equal(main["inducing_points"], main["coarse"]["inducing_points"])
    assert "inducing_points" not in repl and "inducing_points" not in repl["coarse"]
    assert (main["num_iter"] <= 5).all() and (repl["num_iter"] <= 5).all()


@pytest.mark.parametrize("model, cut", [("GPflowSGPRModel", False), ("GPflowGPRModel", True)])
def test_memory_cap_cuts_dense_gpr_buckets_only(monkeypatch, model, cut):
    """auto_batch_cap counts dense [B, N, N] buffers: an SGPR bucket must
    not be cut by it (it is None on the CPU, so it is made to say 1 here)."""
    monkeypatch.setattr(TB, "auto_batch_cap", lambda nmax, device=None, free_share=0.5: 1)
    obs_df, expert_df = _field()
    big = expert_df.iloc[[1, 4]].reset_index(drop=True)  # both in one size bucket
    out = _sweep(obs_df, big, model=model, optim_kwargs={"max_iter": 2, "linesearch": "single_eval"})
    assert [len(r["expert_index"]) for r in out] == ([1, 1] if cut else [2])


def test_sgpr_config_runs_through_the_cli(tmp_path):
    """configs/example_local_expert_oi_sgpr.json, its paths pointed at a
    temporary store of 64 binned points, through the package's CLI on the
    CPU."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(-4e5, 4e5, (64, 2))
    data = pd.DataFrame({"x": xy[:, 0], "y": xy[:, 1],
                         "z": np.sin(xy[:, 0] / 2e5) * np.cos(xy[:, 1] / 3e5) + 0.05 * rng.normal(size=64)})
    src = str(tmp_path / "binned.h5")
    with TableStore(src) as s:
        s.put("data", data)
    cfg = json.loads((REPO / "configs" / "example_local_expert_oi_sgpr.json").read_text())
    cfg["locations"]["source"] = cfg["data"]["data_source"] = src
    cfg["locations"]["row_select"] = [{"col": "x", "comp": "<", "val": -2e5}]
    results = str(tmp_path / "results_sgpr.h5")
    cfg["run_kwargs"].update(store_path=results, device="cpu")
    cfg["model"]["optim_kwargs"]["max_iter"] = 50
    path = tmp_path / "sgpr.json"
    path.write_text(json.dumps(cfg))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "gpsat_tpu_torch.cli", "local_expert_oi", str(path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out, configs = port_results(results)
    rd = out["run_details"]
    n = int((data["x"] < -2e5).sum())
    assert len(rd) == n and (rd["model"] == "gpsat_tpu_torch.SGPRModel").all()
    ran = rd["num_obs"] >= 10
    assert ran.any() and len(out["preds"]) == int(ran.sum())
    assert np.isfinite(out["preds"]["f*"]).all() and out["preds"]["f*"].dtype == np.float32
    assert len(out["inducing_points"]) == int(ran.sum()) * 128 * 2
    assert configs[0]["model"]["oi_model"] == "GPflowSGPRModel"
