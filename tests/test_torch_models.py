"""The port's host-facing model classes (gpsat_tpu_torch/models/{base,gpr,
sgpr,svgp,vff,asvgp}.py) against the JAX package's, on the CPU in f64.

The five classes are built from the same DataFrame (N = 80) in both
packages; the inducing points of SGPR and SVGP come from the same
``np.random`` state. Each JAX ``optimise_parameters`` compiles one program
(two for Adam with natural gradients): seven here, each run once per module
(``fits``). The objectives are compared at the optimum, where the JAX
L-BFGS result holds the value, so that few other JAX programs are built.
SVGP's collapsed solver is held to the JAX SGPR fit, the same L-BFGS on the
same bound, and to JAX's ``collapsed_q`` at its optimum."""

import numpy as np
import pandas as pd
import pytest
import torch

import gpsat_tpu.models as JM
import gpsat_tpu_torch.models as PM
from gpsat_tpu.models import svgp as JSVGP

N, SEED = 80, 1
CONSTRAINTS = {"lengthscales": {"low": 0.1, "high": 20.0}}
# name -> (registry name, constructor kwargs, optimise_parameters kwargs)
CASES = {
    "gpr": ("GPflowGPRModel", {"kernel": "Matern52"}, {"max_iter": 10}),
    "sgpr": ("GPflowSGPRModel", {"num_inducing_points": 30}, {"max_iter": 10}),
    "svgp_lbfgs": ("GPflowSVGPModel", {"num_inducing_points": 20}, {"solver": "lbfgs", "max_iter": 10}),
    "svgp_adam_natgrad": ("GPflowSVGPModel", {"num_inducing_points": 20, "minibatch_size": 40},
                          {"natural_gradients": True, "gamma": 0.2, "max_iter": 20, "check_every": 5,
                           "persistence": 10}),
    "vff": ("GPflowVFFModel", {"num_inducing_features": 5, "domain_size": 4e5}, {"max_iter": 10}),
    "asvgp": ("GPflowASVGPModel", {"num_inducing_features": 8}, {"max_iter": 10}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default thread count oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, size=(n, 2))
    y = np.sin(x[:, 0] / 8e4) * np.cos(x[:, 1] / 1e5) + 0.05 * rng.normal(size=n) + 0.3
    return pd.DataFrame({"x": x[:, 0], "y": x[:, 1], "obs": y})


DATA = dict(coords_col=["x", "y"], obs_col="obs", coords_scale=[5e4, 5e4], obs_mean="local")
XNEW = np.random.default_rng(5).uniform(-2e5, 2e5, size=(6, 2))


def _pair(name, extra, constrain=True):
    """The JAX and the port's model on the same data, inducing points from
    the same np.random state, with the lengthscale constraint."""
    df = _frame()
    np.random.seed(SEED)
    j = JM.get_model(name)(data=df, **DATA, **extra)
    np.random.seed(SEED)
    p = PM.get_model(name)(data=df, **DATA, **extra, device="cpu")
    if constrain:
        for m in (j, p):
            m.set_parameter_constraints(CONSTRAINTS)
    return j, p


def _close(a, b, tol, what):
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k], dtype=float), np.asarray(a[k], dtype=float), rtol=0, atol=tol,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def fits():
    """Each case fitted once in each package: (jax model, port model,
    their optimise_parameters returns)."""
    out = {}
    for case, (name, extra, opt) in CASES.items():
        j, p = _pair(name, extra)
        out[case] = (j, p, j.optimise_parameters(**opt), p.optimise_parameters(**opt))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_constructor_and_predict_match_jax(case):
    name, extra, _ = CASES[case]
    j, p = _pair(name, extra)
    assert list(p.param_names) == list(j.param_names)
    _close(j.get_parameters(), p.get_parameters(), 0.0, "init")
    pj, pp = j.predict(XNEW, full_cov=True), p.predict(XNEW, full_cov=True)
    assert sorted(pp) == sorted(pj) == ["f*", "f*_cov", "f*_var", "f_bar", "y_cov", "y_var"]
    _close(pj, pp, 1e-9, "predict")
    # without full_cov: the same marginals, no covariances
    _close({k: pp[k] for k in ("f*", "f*_var", "y_var", "f_bar")}, p.predict(XNEW), 0.0, "marginals")


def _jax_objective(j):
    """JAX's objective at its optimum: the L-BFGS result's final value (the
    negated bound of the collapsed models) where the class keeps one, an
    eager evaluation for ASVGP, and None for Adam (its full-batch ELBO is
    held to JAX in the lbfgs case)."""
    r = getattr(j, "_last_opt_result", None)
    if type(j).__name__ == "ASVGPModel":
        return j.get_objective_function_value()
    if r is None:
        return None
    return float(r.final_value) if type(j).__name__ == "GPRModel" else -float(r.final_value)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimise_parameters_matches_jax(case, fits):
    j, p, ok_j, ok_p = fits[case]
    if isinstance(ok_j, float) and np.isnan(ok_j):  # Adam ran to max_iter
        assert np.isnan(ok_p)
    else:
        assert ok_p == ok_j
    if getattr(j, "_last_opt_result", None) is not None:
        assert p._last_opt_result.num_iter == int(j._last_opt_result.num_iter)
    if hasattr(j, "_last_num_iter"):
        assert p._last_num_iter == j._last_num_iter
    _close(j.get_parameters(), p.get_parameters(), 1e-8, "optimised")
    oj, op = _jax_objective(j), p.get_objective_function_value()
    assert oj is None or abs(op - oj) <= 1e-10 * abs(oj)
    _close(j.predict(XNEW, full_cov=True), p.predict(XNEW, full_cov=True), 1e-9, "predict")


def test_svgp_collapsed_solver_is_the_jax_sgpr_fit_and_collapsed_q(fits):
    """The collapsed solver is L-BFGS on the SGPR bound over the
    hyperparameters (the same inducing points: the same np.random state and
    M), then q in closed form: held to JAX's SGPR fit and its collapsed_q."""
    js = fits["sgpr"][0]
    _, p = _pair("GPflowSVGPModel", {"num_inducing_points": 30})
    assert p.optimise_parameters(solver="collapsed", max_iter=10) == fits["sgpr"][2]
    assert p._last_num_iter == int(js._last_opt_result.num_iter)
    want = js.get_parameters()
    _close(want, {k: p.get_parameters()[k] for k in want}, 1e-8, "collapsed")
    q_mu, q_sqrt = JSVGP.collapsed_q({k: np.asarray(v) for k, v in js._params.items()}, js._data_dict(),
                                     kernel=js.kernel, jitter=js.jitter)
    np.testing.assert_allclose(p.get_inducing_mean()[:, 0], np.asarray(q_mu), rtol=0, atol=1e-8)
    np.testing.assert_allclose(p.get_inducing_chol()[0], np.asarray(q_sqrt), rtol=0, atol=1e-8)
    with pytest.raises(ValueError):
        p.optimise_parameters(solver="newton")


def test_getters_setters_constraints_and_mean_function():
    j, p = _pair("GPflowGPRModel", {"mean_function": "Linear", "mean_func_kwargs": {"b": 0.2, "A": [0.1, -0.1]},
                                    "kernel_kwargs": {"lengthscales": 3.0}, "noise_variance": 0.01},
                 constrain=False)
    assert list(p.param_names) == list(j.param_names) == [
        "lengthscales", "kernel_variance", "likelihood_variance", "mean_c", "mean_A"]
    # on the class, param_names is the batched lane's
    assert PM.GPRModel.param_names == ("lengthscales", "kernel_variance", "likelihood_variance")
    assert PM.VFFModel.param_names[-1] == "domain" and PM.ASVGPModel.param_names[-1] == "knots"
    _close(j.get_parameters(), p.get_parameters(), 0.0, "init")
    new = {"lengthscales": [2.0, 30.0], "kernel_variance": 0.5, "likelihood_variance": 0.02, "mean_c": -0.1}
    for m in (j, p):
        m.set_parameters(**new)
        # a value outside the interval is moved inside it, by tol
        m.set_parameter_constraints({"lengthscales": {"low": 0.5, "high": 20.0},
                                     "kernel_variance": {"low": 1e-3, "high": 2.0}}, tol=1e-2)
    _close(j.get_parameters(), p.get_parameters(), 0.0, "constrained")
    assert p.get_lengthscales()[1] == pytest.approx(20.0 - 1e-2)
    assert p._bijectors["kernel_variance"].name == "sigmoid" and p._bijectors["likelihood_variance"].name == "softplus"
    with pytest.raises(AssertionError):
        p.set_parameter_constraints({"kernel_variance": {"low": 2.0, "high": 1.0}})
    # a DataFrame of prediction locations, and the un-scaled form
    locs = pd.DataFrame(XNEW, columns=["x", "y"])
    _close(j.predict(locs), p.predict(locs), 1e-9, "frame")
    _close(j.predict(XNEW / 5e4, apply_scale=False), p.predict(XNEW / 5e4, apply_scale=False), 1e-9, "unscaled")


def test_update_obs_data_keeps_the_parameters():
    j, p = _pair("GPflowGPRModel", {})
    other = _frame(seed=3, n=60)
    for m in (j, p):
        m.set_parameters(lengthscales=[2.0, 4.0], likelihood_variance=0.01)
        m.update_obs_data(data=other, **DATA)
    assert p.coords.shape == (60, 2)
    for k in ("coords", "obs", "obs_mean", "coords_scale", "obs_scale"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k), err_msg=k)
    _close(j.get_parameters(), p.get_parameters(), 0.0, "kept")
    # the objective is the new data's: a model built on it with these params
    fresh = PM.GPRModel(data=other, **DATA, device="cpu")
    fresh.set_parameters(**p.get_parameters())
    assert p.get_objective_function_value() == fresh.get_objective_function_value()


def test_arrays_device_and_dtype():
    df = _frame()
    coords, obs = df[["x", "y"]].to_numpy(), df["obs"].to_numpy()
    # the card by default: no card here, so it raises
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.GPRModel(coords=coords, obs=obs)
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.TorchGPRModel(coords=coords, obs=obs)
    m = PM.GPRModel(coords=coords / 5e4, obs=obs, device="cpu", dtype="float32")
    assert m.dtype == torch.float32 and m.coords_col == [0, 1]
    # f32 takes the f32 tolerances and the single-eval search
    assert m.optimise_parameters(max_iter=50)
    assert m._last_opt_result.num_iter < 50
    assert np.isfinite(m.predict(np.zeros(2))["f*"]).all()
    # a 1-d coordinate array is one dimension
    one = PM.SGPRModel(coords=coords[:, 0] / 5e4, obs=obs, num_inducing_points=500, device="cpu")
    assert one.get_inducing_points().shape == (N, 1)
