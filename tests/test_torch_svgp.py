"""The port's SVGP core (gpsat_tpu_torch/models/svgp.py) and its Adam runner
against the JAX package's (gpsat_tpu/models/svgp.py, parallel/engine.py)
on the CPU, in f64.

The ELBO, its gradient in every parameter and the predictions are held at
1e-10 relative (``RTOL``): the JAX package solves with ``cholesky`` +
``tri_solve`` in f64, the port multiplies by W = L^-1 from the factor pair,
so the two agree at f64 roundoff, not bit for bit. The batched fits are
held at 1e-6 on predictions (``FIT_TOL``). Six JAX programs are compiled:
the collapsed fit, the Bernoulli joint L-BFGS fit, the three Adam fits
(natural gradients; Poisson; Bernoulli with natural gradients) and one
``LocalExpertOI`` run (the SVGP config, which the port runs through its
CLI)."""

import json

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import gpsat_tpu.models.svgp as JS
from gpsat_tpu.experts import get_results_from_h5file as jax_results
from gpsat_tpu.parallel import engine as JE
from gpsat_tpu.parallel.batching import TileBatch as JTileBatch
from gpsat_tpu_torch.convert import batch_from_numpy, params_from_numpy
from gpsat_tpu_torch.experts import get_results_from_h5file as port_results
from gpsat_tpu_torch.models import SVGPModel, get_model
from gpsat_tpu_torch.models import sgpr as TSG
from gpsat_tpu_torch.models import svgp as TS
from gpsat_tpu_torch.parallel import engine as TE

RTOL = 1e-10
FIT_TOL = 1e-6
# Adam fits with a free parameter that no likelihood term reads
ADAM_UNUSED_TOL = 1e-10
LIKELIHOODS = ("Gaussian", "StudentT", "Bernoulli", "Poisson")
CONFIG = "configs/example_local_expert_oi_svgp.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_oi.py: six pytest workers
    share the machine's cores in the tier-1 run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(y, likelihood, rng):
    if likelihood == "Bernoulli":
        return (y > 0).astype(float)
    if likelihood == "Poisson":
        return rng.poisson(np.exp(y)).astype(float)
    return y


def _tiles(likelihood="Gaussian", B=3, N=100, M=16, D=2, seed=0):
    """Masked tiles (full, 30 rows padded, 10 valid rows with a far-padded
    inducing set) and a q with a free upper triangle, which must not count."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 5, (B, N, D))
    y = _labels(np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N)), likelihood, rng)
    mask = np.ones((B, N))
    mask[1, -30:] = 0.0
    mask[2, 10:] = 0.0
    Z = np.stack([X[b, rng.choice(int(mask[b].sum()), M, replace=False)] if mask[b].sum() >= M
                  else TSG.pad_inducing_points(X[b, : int(mask[b].sum())], M, data_span=6.0) for b in range(B)])
    chol = np.tril(0.3 * rng.normal(size=(B, M, M))) + np.eye(M) * 0.8 + np.triu(rng.normal(size=(B, M, M)), 1)
    cp = {
        "lengthscales": np.array([[1.0, 1.3], [0.7, 0.9], [1.5, 2.0]])[:B],
        "kernel_variance": np.array([0.8, 1.1, 0.5])[:B],
        "likelihood_variance": np.array([0.05, 0.02, 0.1])[:B],
        "inducing_points": Z,
        "inducing_mean": 0.5 * rng.normal(size=(B, M)),
        "inducing_chol": chol,
    }
    return X, y, mask, cp


def _jax_tile(X, y, mask, cp, b):
    return ({k: jnp.asarray(v[b]) for k, v in cp.items()},
            {"X": jnp.asarray(X[b]), "y": jnp.asarray(y[b]), "mask": jnp.asarray(mask[b])})


def _port(X, y, mask, cp, grad=True):
    return ({k: torch.tensor(v, requires_grad=grad) for k, v in cp.items()},
            {"X": torch.tensor(X), "y": torch.tensor(y), "mask": torch.tensor(mask)})


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale, (what, float(np.abs(got - want).max()) / scale)


@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_elbo_and_its_gradient_match_jax(likelihood):
    import jax

    X, y, mask, cp = _tiles(likelihood)
    tc, td = _port(X, y, mask, cp)
    e = TS.elbo(tc, td, kernel="Matern32", likelihood=likelihood)
    e.sum().backward()
    fn = jax.jit(jax.vmap(jax.value_and_grad(lambda c, d: JS.elbo(c, d, kernel="Matern32", likelihood=likelihood))))
    jv, jg = fn({k: jnp.asarray(v) for k, v in cp.items()},
                {"X": jnp.asarray(X), "y": jnp.asarray(y), "mask": jnp.asarray(mask)})
    for b in range(len(X)):
        _close(e[b].item(), float(jv[b]), what=(likelihood, b, "elbo"))
        for k in cp:
            # a parameter the likelihood does not read (Bernoulli's variance)
            # has no gradient in the port and a zero one in JAX
            got = torch.zeros_like(tc[k][b]) if tc[k].grad is None else tc[k].grad[b]
            _close(got.numpy(), np.asarray(jg[k][b]), what=(likelihood, b, k))
    # the upper triangle of the factor carries no gradient
    assert float(torch.triu(tc["inducing_chol"].grad, 1).abs().max()) == 0.0


def test_chunked_elbo_equals_unchunked():
    """N=700 in chunks of 128 (the last one short) against the whole tile:
    value and gradient, and the value against the JAX package's chunked ELBO."""
    X, y, mask, cp = _tiles("StudentT", N=700)
    vals, grads = [], []
    for chunk in (None, 128):
        tc, td = _port(X, y, mask, cp)
        e = TS.elbo(tc, td, kernel="Matern32", likelihood="StudentT", chunk_size=chunk)
        e.sum().backward()
        vals.append(e.detach().numpy())
        grads.append({k: v.grad.numpy() for k, v in tc.items()})
    _close(vals[1], vals[0], rtol=1e-12, what="value")
    for k in cp:
        _close(grads[1][k], grads[0][k], rtol=1e-12, what=k)
    jc, jd = _jax_tile(X, y, mask, cp, 1)
    _close(vals[1][1], float(JS.elbo(jc, jd, kernel="Matern32", likelihood="StudentT", chunk_size=128)),
           what="jax chunked")


def test_minibatch_elbo_matches_jax():
    X, y, mask, cp = _tiles()
    idx = np.random.default_rng(3).choice(100, 40, replace=False)
    tc, td = _port(X, y, mask, cp, grad=False)
    e = TS.elbo(tc, td, kernel="Matern32", batch_idx=torch.as_tensor(idx))
    for b in range(len(X)):
        jc, jd = _jax_tile(X, y, mask, cp, b)
        _close(e[b].item(), float(JS.elbo(jc, jd, kernel="Matern32", batch_idx=jnp.asarray(idx))), what=b)


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_matches_jax(full_cov):
    X, y, mask, cp = _tiles()
    Xnew = np.random.default_rng(1).uniform(0, 5, (3, 7, 2))
    tc, td = _port(X, y, mask, cp, grad=False)
    out = TS.predict(tc, td, torch.tensor(Xnew), kernel="Matern52", full_cov=full_cov)
    assert ("f_cov" in out) == full_cov
    for b in range(len(X)):
        jc, jd = _jax_tile(X, y, mask, cp, b)
        ref = JS.predict(jc, jd, jnp.asarray(Xnew[b]), kernel="Matern52", full_cov=full_cov)
        for k in ref:
            _close(out[k][b].numpy(), np.asarray(ref[k]), what=(b, k))


def test_collapsed_q_and_natgrad_step_match_jax():
    X, y, mask, cp = _tiles()
    tc, td = _port(X, y, mask, cp, grad=False)
    q_mu, q_sqrt = TS.collapsed_q(tc, td, kernel="Matern32")

    def loss_t(m, S):
        eye = torch.eye(S.shape[-1], dtype=S.dtype)
        return -TS.elbo({**tc, "inducing_mean": m, "inducing_chol": TS._cholesky(S + 1e-12 * eye)}, td,
                        kernel="Matern32")

    m_new, qs_new = TS.natgrad_step(loss_t, tc["inducing_mean"], tc["inducing_chol"], 0.3)

    def jax_both(jc, jd):
        def loss_j(m, S):
            Lq = jnp.linalg.cholesky(S + 1e-12 * jnp.eye(S.shape[0]))
            return -JS.elbo({**jc, "inducing_mean": m, "inducing_chol": Lq}, jd, kernel="Matern32")

        return (JS.collapsed_q(jc, jd, kernel="Matern32"),
                JS.natgrad_step(loss_j, jc["inducing_mean"], jc["inducing_chol"], 0.3))

    import jax

    (jm, js), (jm2, js2) = jax.jit(jax.vmap(jax_both))(
        {k: jnp.asarray(v) for k, v in cp.items()}, {"X": jnp.asarray(X), "y": jnp.asarray(y), "mask": jnp.asarray(mask)})
    for b in range(len(X)):
        _close(q_mu[b].numpy(), np.asarray(jm[b]), what=(b, "q_mu"))
        _close(q_sqrt[b].numpy(), np.asarray(js[b]), what=(b, "q_sqrt"))
        # the step solves with three more factors: 1e-9
        _close(m_new[b].numpy(), np.asarray(jm2[b]), rtol=1e-9, what=(b, "natgrad mean"))
        _close(qs_new[b].numpy(), np.asarray(js2[b]), rtol=1e-9, what=(b, "natgrad chol"))


def _fit_batch(likelihood="Gaussian", B=3, N=96, P=6, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, 2))
    y = _labels(np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N)), likelihood, rng)
    mask = np.ones((B, N))
    mask[1, -20:] = 0.0
    mask[2, 40:] = 0.0
    fill = mask.sum(1).astype(int)
    return JTileBatch(
        X=X, y=y, mask=mask, Xnew=rng.uniform(-2, 2, (B, P, 2)), pred_mask=np.ones((B, P)), obs_mean=np.zeros(B),
        expert_index=np.arange(B), num_obs=fill,
    )


@pytest.mark.parametrize(
    "kind",
    ["collapsed", "bernoulli_lbfgs", "adam_natgrad", "poisson_adam", "bernoulli_natgrad"],
)
def test_batched_fit_matches_jax(kind):
    """The three solvers through each package's engine from the same
    init, f64 on the CPU: the collapsed bound with the default f64 search
    (zoom), the Bernoulli joint L-BFGS fit, and 30 Adam + natural-gradient
    iterations. The inducing points are drawn by both packages' cores.

    The last two run 40 Adam steps on cores whose likelihood never reads
    the free ``likelihood_variance`` (Poisson with plain Adam, N = 96;
    Bernoulli with natural gradients, N = 128): its gradient is zero in
    both packages, Adam leaves it where it is, and the fits agree to f64
    roundoff (``ADAM_UNUSED_TOL``)."""
    M = 12
    tol = FIT_TOL
    N = 96
    if kind == "collapsed":
        make = dict(num_inducing_points=M)
        run_kw = dict(max_iter=200)
        lik = "Gaussian"
    elif kind == "bernoulli_lbfgs":
        make = dict(num_inducing_points=M, likelihood="Bernoulli")
        run_kw = dict(max_iter=400)
        lik = "Bernoulli"
    elif kind == "adam_natgrad":
        make = dict(num_inducing_points=M, natural_gradients=True, gamma=0.5)
        run_kw = dict(max_iter=30, learning_rate=1e-2, check_every=10, persistence=100)
        lik = "Gaussian"
    else:
        lik = "Poisson" if kind == "poisson_adam" else "Bernoulli"
        make = dict(num_inducing_points=M, likelihood=lik)
        make.update(solver="adam") if lik == "Poisson" else make.update(natural_gradients=True, gamma=0.5)
        run_kw = dict(max_iter=40, learning_rate=1e-2, check_every=10, persistence=100)
        tol = ADAM_UNUSED_TOL
        N = 96 if lik == "Poisson" else 128
    batch = _fit_batch(lik, N=N)
    jcore = JS.make_svgp_core(**make)
    tcore = TS.make_svgp_core(**make)
    assert jcore.optimizer == tcore.optimizer and jcore.name == tcore.name
    assert tuple(jcore.default_fixed_params) == tuple(tcore.default_fixed_params)
    init = {"smart_init": True}
    jmake = JE.make_batched_adam_runner if jcore.optimizer == "adam" else JE.make_batched_runner
    jrun = jmake(jcore, fixed_params=jcore.default_fixed_params, **run_kw)
    trun = TE.make_runner_for(tcore, fixed_params=tcore.default_fixed_params, device="cpu", **run_kw)
    jres = JE.run_tile_batch(batch, dict(init), jrun, jcore)
    tres = TE.run_tile_batch(batch_from_numpy(batch), dict(init), trun, tcore, device="cpu")
    assert np.asarray(jres["converged"]).all() and tres["converged"].all(), (jres["num_iter"], tres["num_iter"])
    np.testing.assert_array_equal(tres["inducing_points"], np.asarray(jres["inducing_points"]))
    for k in ("f_mean", "f_var"):
        d = float(np.abs(tres[k] - np.asarray(jres[k])).max())
        assert d <= tol, (kind, k, d, jres["num_iter"], tres["num_iter"])
    _close(tres["objective"], np.asarray(jres["objective"]), rtol=1e-8, what=(kind, "objective"))
    # the JAX results carried across (the factor's upper triangle as stored)
    # predict the JAX predictions in the port
    cp = params_from_numpy({k: jres[k] for k in tcore.param_names}, "cpu", torch.float64)
    tb = batch_from_numpy(batch)
    data = {"X": torch.tensor(tb.X), "y": torch.tensor(tb.y), "mask": torch.tensor(tb.mask)}
    carried = tcore.predict(cp, data, torch.tensor(tb.Xnew))
    for k in ("f_mean", "f_var"):
        _close(carried[k].numpy(), np.asarray(jres[k]), what=(kind, "carried", k))
    if tcore.optimizer == "adam":
        np.testing.assert_array_equal(tres["num_iter"], np.asarray(jres["num_iter"]))
    if tol == ADAM_UNUSED_TOL:
        # the parameter no likelihood term reads stays at its start (the
        # bijector's round trip aside)
        np.testing.assert_allclose(tres["likelihood_variance"], np.asarray(jres["likelihood_variance"]), rtol=1e-14)


def test_registry_and_solver_rules():
    assert get_model("GPflowSVGPModel") is SVGPModel and get_model("SVGPModel") is SVGPModel
    assert SVGPModel.param_names == tuple(JS.PARAM_NAMES)
    # the host-serial lane's models resolve since it was ported
    assert get_model("sklearnGPRModel").__name__ == "SklearnGPRModel"
    assert get_model("PurePythonGPR").__name__ == "PureNumpyGPR"
    cases = [dict(), dict(likelihood="StudentT"), dict(natural_gradients=True), dict(natural_gradients="exact"),
             dict(solver="adam", q_init=None), dict(likelihood="Poisson", solver="adam"),
             dict(solver="lbfgs", q_init="collapsed"), dict(train_inducing_points=True, mean_function="Linear")]
    for kw in cases:
        j, t = JS.make_svgp_core(num_inducing_points=8, **kw), TS.make_svgp_core(num_inducing_points=8, **kw)
        assert (t.name, t.optimizer, tuple(t.param_names), tuple(t.default_fixed_params), tuple(t.natgrad_params)) == (
            j.name, j.optimizer, tuple(j.param_names), tuple(j.default_fixed_params), tuple(j.natgrad_params)), kw
        assert (t.device_init is None, t.finalize_params is None) == (j.device_init is None,
                                                                     j.finalize_params is None), kw
        init_j, init_t = j.init_cparams(2), t.init_cparams(2, overrides={"likelihood_variance": 0.3})
        assert set(init_j) == set(init_t) and float(init_t["likelihood_variance"]) == 0.3
    for bad in (dict(solver="collapsed", likelihood="Bernoulli"), dict(solver="collapsed", natural_gradients=True),
                dict(solver="lbfgs", natural_gradients=True), dict(natural_gradients="exact", likelihood="Poisson")):
        with pytest.raises(AssertionError):
            TS.make_svgp_core(**bad)


def test_q_init_auto_keeps_a_loaded_q_lane_by_lane():
    X, y, mask, cp = _tiles()
    core = TS.make_svgp_core(num_inducing_points=16, likelihood="StudentT")
    u0 = core.inverse({k: torch.tensor(v) for k, v in cp.items()})
    u0["inducing_mean"][0] = 0.0
    u0["inducing_chol"][0] = torch.eye(16, dtype=torch.float64)
    out = core.device_init(u0, {"X": torch.tensor(X), "y": torch.tensor(y), "mask": torch.tensor(mask)})
    q_mu, _ = TS.collapsed_q({k: torch.tensor(v) for k, v in cp.items()},
                             {"X": torch.tensor(X), "y": torch.tensor(y), "mask": torch.tensor(mask)}, kernel="Matern32")
    # the hook reads the hyperparameters back through their softplus: 1e-12
    torch.testing.assert_close(out["inducing_mean"][0], q_mu[0], rtol=0, atol=1e-12)
    torch.testing.assert_close(out["inducing_mean"][1:], u0["inducing_mean"][1:], rtol=0, atol=0)
    torch.testing.assert_close(out["inducing_chol"][1:], u0["inducing_chol"][1:], rtol=0, atol=0)


def test_svgp_config_runs_through_the_cli_and_matches_jax(tmp_path):
    """configs/example_local_expert_oi_svgp.json (M = 64, Gaussian: the
    collapsed solver, max_iter 2000), its paths pointed at a temporary store
    of 64 points, through the port's CLI on the CPU in f64 (the default zoom
    search) and through the JAX package's run_from_config; the predictions
    agree and each package's store reads in the other."""
    from gpsat_tpu.local_expert_oi import run_from_config as jax_run
    from gpsat_tpu_torch import cli
    from gpsat_tpu_torch.data.store import TableStore

    rng = np.random.default_rng(3)
    xy = rng.uniform(-4e5, 4e5, (64, 2))
    data = pd.DataFrame({"x": xy[:, 0], "y": xy[:, 1],
                         "z": np.sin(xy[:, 0] / 2e5) * np.cos(xy[:, 1] / 3e5) + 0.05 * rng.normal(size=64)})
    src = str(tmp_path / "binned.h5")
    with TableStore(src) as s:
        s.put("data", data)
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["locations"]["source"] = cfg["data"]["data_source"] = src
    cfg["locations"]["row_select"] = [{"col": "x", "comp": "<", "val": -2e5}]
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    port_cfg = json.loads(json.dumps(cfg))
    port_cfg["run_kwargs"].update(store_path=tpath, device="cpu", dtype="float64")
    path = tmp_path / "svgp.json"
    path.write_text(json.dumps(port_cfg))
    assert cli.main(["local_expert_oi", str(path)]) == 0
    cfg["run_kwargs"]["store_path"] = jpath
    jax_run(cfg)
    jout, _ = jax_results(jpath)
    tout, configs = port_results(tpath)
    n = int((data["x"] < -2e5).sum())
    assert len(tout["run_details"]) == n and (tout["run_details"]["model"] == "gpsat_tpu_torch.SVGPModel").all()
    ran = tout["run_details"]["num_obs"] >= 10
    assert ran.sum() >= 2 and tout["run_details"]["optimise_success"][ran].all()
    assert configs[0]["model"]["oi_model"] == "GPflowSVGPModel"
    for name in ("inducing_mean", "inducing_chol", "inducing_points", "lengthscales"):
        assert len(jout[name]) == len(tout[name]) == int(ran.sum()) * {"inducing_mean": 64, "inducing_chol": 64 * 64,
                                                                        "inducing_points": 128, "lengthscales": 2}[name]
    for col in ("f*", "f*_var"):
        np.testing.assert_allclose(tout["preds"][col].to_numpy(), jout["preds"][col].to_numpy(), rtol=0, atol=FIT_TOL)
    # the stores read across: each package's reader on the other's store
    cross, _ = port_results(jpath)
    np.testing.assert_array_equal(cross["preds"]["f*"].to_numpy(), jout["preds"]["f*"].to_numpy())
    back, _ = jax_results(tpath)
    np.testing.assert_array_equal(back["inducing_chol"]["inducing_chol"].to_numpy(),
                                  tout["inducing_chol"]["inducing_chol"].to_numpy())
