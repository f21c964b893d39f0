"""The port's host-serial lane (gpsat_tpu_torch/experts.py ``run_host_batch``,
``_HostCore``) against the JAX package's, on the CPU.

``LocalExpertOI`` runs the same config through both packages with each host
model: the port's own copies of PureNumpyGPR (numpy and scipy),
TorchGPRModel (torch, f32 as in the reference) and sklearnGPRModel
(sklearn, whose restarts draw from the global ``np.random`` state, seeded
alike before each run), and a user's class given as ``{"path_to_model",
"model_name"}``. The result tables must be the JAX package's to 1e-8 (the
same code on the same data gives them bit for bit). No JAX program is
compiled: the JAX host lane runs these models as they are. Restart and
reload, the route by class, and the device and dtype a host model is
handed are checked on the port alone."""

import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.experts import LocalExpertOI as JOI
from gpsat_tpu.experts import get_results_from_h5file as jax_results
from gpsat_tpu_torch.experts import LocalExpertOI as TOI
from gpsat_tpu_torch.experts import batched_lane, lane_core, sweep
from gpsat_tpu_torch.experts import get_results_from_h5file as port_results
from gpsat_tpu_torch.models import get_model

# a user's model with the BaseGPRModel contract and nothing of either package:
# the tile mean, with the observations' variance as its noise
CUSTOM_MODEL = '''
import numpy as np


class TileMean:
    def __init__(self, coords, obs, verbose=False, shrink=1.0):
        self.obs = np.asarray(obs, dtype=float).reshape(-1)
        self.shrink = float(shrink)
        self.nv = 1.0

    @property
    def param_names(self):
        return ["likelihood_variance"]

    def get_likelihood_variance(self):
        return self.nv

    def set_likelihood_variance(self, v):
        self.nv = float(np.ravel(v)[0])

    def optimise_parameters(self):
        self.nv = float(np.var(self.obs))
        return True

    def get_objective_function_value(self):
        return float(np.sum((self.obs - self.obs.mean()) ** 2) / self.nv)

    def predict(self, coords):
        n = len(np.atleast_2d(coords))
        return {"f*": np.full(n, self.shrink * self.obs.mean()), "f*_var": np.full(n, self.nv / len(self.obs))}
'''

MODELS = {
    "pure_numpy": ("PurePythonGPR", {}, {}),
    "torch": ("GPyTorchGPRModel", {}, {"n_iter": 20}),
    "sklearn": ("sklearnGPRModel", {"noise_variance": 0.0025}, {}),
    "custom": ({"path_to_model": "tile_mean_model", "model_name": "TileMean"}, {"shrink": 0.5}, {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default thread count oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(7)
    n = 200
    x, y = rng.uniform(-3, 3, n), rng.uniform(-3, 3, n)
    obs = np.sin(x) * np.cos(y) + 0.05 * rng.normal(size=n)
    return pd.DataFrame({"x": x, "y": y, "obs": obs}), pd.DataFrame({"x": [0.0, 1.5, -1.5], "y": [0.0, 0.5, -0.5]})


def _config(field, model, init_params=None, optim_kwargs=None, **extra):
    obs_df, expert_df = field
    return dict(
        expert_loc_config={"source": expert_df},
        data_config={"data_source": obs_df, "obs_col": "obs", "coords_col": ["x", "y"],
                     "local_select": [{"col": ["x", "y"], "comp": "<", "val": 2.0}]},
        model_config={"oi_model": model, "init_params": init_params or {}, "optim_kwargs": optim_kwargs or {},
                      **extra},
        pred_loc_config={"method": "shift_arrays", "x": np.array([-0.25, 0.25]), "y": np.array([0.0])},
    )


def _sorted(df):
    keys = [c for c in ("x", "y", "_dim_0") if c in df.columns]
    return df.sort_values(keys).reset_index(drop=True)


@pytest.fixture(scope="module")
def runs(field, tmp_path_factory):
    """Each model's run in both packages: {case: (jax tables, port tables,
    port store path)}."""
    d = tmp_path_factory.mktemp("host")
    (d / "tile_mean_model.py").write_text(CUSTOM_MODEL)
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(str(d))
    out = {}
    try:
        for case, (model, ip, opt) in MODELS.items():
            paths = [str(d / f"{pkg}_{case}.h5") for pkg in ("jax", "port")]
            np.random.seed(0)
            JOI(**_config(field, model, ip, opt)).run(store_path=paths[0])
            np.random.seed(0)
            TOI(**_config(field, model, ip, opt)).run(store_path=paths[1], device="cpu")
            out[case] = (jax_results(paths[0])[0], port_results(paths[1])[0], paths[1])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", sorted(MODELS))
def test_host_lane_tables_match_jax(case, runs):
    J, P, _ = runs[case]
    assert sorted(P) == sorted(J)
    for t in J:
        a, b = _sorted(J[t]), _sorted(P[t])
        assert list(a.columns) == list(b.columns) and len(a) == len(b), t
        for c in a.columns:
            if c in ("run_time", "model", "device", "config_id"):
                continue
            if a[c].dtype.kind == "f":
                np.testing.assert_allclose(b[c], a[c], rtol=0, atol=1e-8, equal_nan=True, err_msg=f"{t}.{c}")
            else:
                np.testing.assert_array_equal(b[c], a[c], err_msg=f"{t}.{c}")
    rd = P["run_details"]
    assert rd["optimise_success"].all() and len(rd) == 3
    name = MODELS[case][0]
    cls = "TileMean" if case == "custom" else get_model(name).__name__
    assert (rd["model"] == f"gpsat_tpu_torch.{cls}").all()
    # the iteration count where the model keeps one, NaN where sklearn hides it
    assert rd["num_iter"].isna().all() == (case in ("sklearn", "custom"))


def test_host_restart_and_reload(field, runs):
    _, P, path = runs["sklearn"]
    model, ip, opt = MODELS["sklearn"]
    # a rerun finds every expert done and runs nothing
    TOI(**_config(field, model, ip, opt)).run(store_path=path, device="cpu")
    assert len(port_results(path)[0]["run_details"]) == len(P["run_details"])
    # predict-only from the stored parameters reproduces the predictions
    TOI(**_config(field, model, ip, opt, load_params={"file": path})).run(
        store_path=path, device="cpu", optimise=False, table_suffix="_R",
        skip_valid_checks_on=["model", "run_kwargs"])
    R = port_results(path, table_suffix="_R")[0]
    np.testing.assert_allclose(_sorted(R["preds_R"])["f*"], _sorted(P["preds"])["f*"], rtol=1e-9)


def test_routes_by_class(field):
    # the route is the class's: the five batched classes by identity or name,
    # every other class the host lane; a batched core that cannot be built
    # raises and is not sent to the host lane (profile_dir runs in
    # tests/test_torch_oi.py::test_options_that_were_not_ported_run)
    model = MODELS["torch"][0]
    assert [batched_lane(get_model(n)) for n in ("GPflowGPRModel", "GPflowVFFModel", "PurePythonGPR")] == [
        "GPRModel", "VFFModel", None]
    assert type(lane_core(get_model("PurePythonGPR"), {}, None, {}, 2)).__name__ == "_HostCore"
    obs_df, expert_df = field
    with pytest.raises(ValueError, match="VFF kernel"):
        next(sweep(obs_df, expert_df, coords_col=["x", "y"], obs_col="obs", local_select=None,
                   pred_loc=TOI(**_config(field, model)).pred_loc, model="GPflowVFFModel",
                   init_params={"kernel": "RBF", "num_inducing_features": 3}, device="cpu"))


def test_host_lane_takes_device_and_dtype(field):
    """The sweep hands its device and dtype to a host model that names them:
    TorchGPRModel in f64 on the CPU (the card run of chip_smoke.py phase 12
    is held to this)."""
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations

    obs_df, expert_df = field
    pred_loc = PredictionLocations(method="expert_loc", coords_col=["x", "y"])
    kw = dict(coords_col=["x", "y"], obs_col="obs", local_select=[{"col": ["x", "y"], "comp": "<", "val": 2.0}],
              pred_loc=pred_loc, model="GPyTorchGPRModel", optim_kwargs={"n_iter": 5}, device="cpu")
    out = {dt: [r for r in sweep(obs_df, expert_df, dtype=dt, **kw) if not r.get("skipped")]
           for dt in (torch.float32, torch.float64)}
    (r32,), (r64,) = out[torch.float32], out[torch.float64]
    assert r64["lane"] == "main" and r64["model"] == "TorchGPRModel" and (r64["num_iter"] == 5).all()
    # f32 and f64 runs of the same 5 Adam steps agree to f32 roundoff, not more
    d = np.abs(r32["f_mean"] - r64["f_mean"]).max()
    assert 0 < d < 1e-4
