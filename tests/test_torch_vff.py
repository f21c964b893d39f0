"""The port's inter-domain cores (gpsat_tpu_torch/models/vff.py and asvgp.py)
against the JAX package's (gpsat_tpu/models/vff.py, asvgp.py), on the CPU.

The bounds, their gradients and the full-covariance predictions of one
tile are held at 1e-10 relative (gradients 1e-8): the JAX package solves
with ``cholesky`` + ``tri_solve`` in f64, the port multiplies by W = L^-1
from the factor pair, so the two agree at f64 roundoff. The JAX side runs
them one tile at a time, outside ``vmap``.

Two JAX programs are compiled, one per model: the model block of
``configs/example_local_expert_oi_vff.json`` (and the same block with
``GPflowASVGPModel``) through the JAX package's ``run_from_config`` in
f64 on a 400-point field. The port runs the same config through its CLI
(its engine on the config's one tile bucket) and is held to the JAX
tables; the JAX parameters carried into the port and the port's f32 fit
of that bucket are held to the same tables.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import gpsat_tpu.models.asvgp as JA
import gpsat_tpu.models.vff as JV
from gpsat_tpu.experts import get_results_from_h5file as jax_results
from gpsat_tpu_torch.convert import params_from_numpy
from gpsat_tpu_torch.experts import core_for, initial_cparams
from gpsat_tpu_torch.experts import get_results_from_h5file as port_results
from gpsat_tpu_torch.models import ASVGPModel, VFFModel, get_model
from gpsat_tpu_torch.models import asvgp as TA
from gpsat_tpu_torch.models import vff as TV
from gpsat_tpu_torch.parallel import batching as TB
from gpsat_tpu_torch.parallel import engine as TE
from gpsat_tpu_torch.utils import flops

CONFIG = "configs/example_local_expert_oi_vff.json"
RTOL = 1e-10
GRAD_RTOL = 1e-8
PARAM_RTOL = 1e-6
PRED_TOL = 1e-8
F32_TOL = 1e-2  # the raw-f32 band against f64 gold (ACCURACY_r05.log)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six pytest workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    d = float(np.abs(got - want).max())
    assert d <= rtol * max(1.0, float(np.abs(want).max())), (what, d)


# --------------------------------------------------------------------------
# one tile: the bound, its gradient and the full-covariance posterior
# --------------------------------------------------------------------------


def _tile(n=40, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, 2))
    y = np.sin(1.3 * X[:, 0]) * np.cos(X[:, 1]) + 0.1 * rng.normal(size=n)
    mask = np.ones(n)
    mask[-5:] = 0.0
    Xnew = np.concatenate([rng.uniform(-1.5, 1.5, (3, 2)), [[1.95, -1.9], [-1.98, 1.7]]])
    return X, y, mask, Xnew


CASES = [("vff", k) for k in JV.SUPPORTED_KERNELS] + [("asvgp", k) for k in ("Matern12", "Matern32", "Matern52")]


@pytest.mark.parametrize("model, kernel", CASES, ids=[f"{m}_{k}" for m, k in CASES])
def test_bound_gradient_and_predict_match_jax(model, kernel):
    """VFF (M = 4) and ASVGP (M = 6) on one f64 tile, D = 2: the bound
    within 1e-10 relative, its gradient in every hyperparameter (and the
    Constant mean's, on the Matern32 cases) within 1e-8, and the posterior
    with ``full_cov`` within 1e-10. VFF's Matern12/32 domain leaves points
    of the data and of Xnew outside [a, b], so the edge corrections count."""
    X, y, mask, Xnew = _tile()
    c = {"lengthscales": np.array([0.8, 1.3]), "kernel_variance": np.array(1.4), "likelihood_variance": np.array(0.05)}
    if kernel == "Matern32":
        c["mean_c"] = np.array(0.2)
    if model == "vff":
        a, b = (np.array([-1.6, -1.7]), np.array([1.5, 1.8])) if kernel != "Matern52" else (
            np.array([-2.2, -2.1]), np.array([2.1, 2.3]))
        assert (X < a).any() and (X > b).any() or kernel == "Matern52"
        kw = dict(kernel=kernel, M=4)

        def jfun(cj, data):
            return JV.elbo(cj, data, a=jnp.asarray(a), b=jnp.asarray(b), **kw)

        def jpred(cj, data):
            return JV.predict(cj, data, jnp.asarray(Xnew), a=jnp.asarray(a), b=jnp.asarray(b), full_cov=True, **kw)

        at, bt = torch.tensor(a)[None], torch.tensor(b)[None]

        def tfun(ct, data):
            return TV.elbo(ct, data, a=at, b=bt, **kw)

        def tpred(ct, data):
            return TV.predict(ct, data, torch.tensor(Xnew)[None], a=at, b=bt, full_cov=True, **kw)
    else:
        knots = np.stack([np.linspace(X[:, d].min() - 0.1, X[:, d].max() + 0.1, 6) for d in range(2)])

        def jfun(cj, data):
            return JA.elbo(cj, data, [jnp.asarray(k) for k in knots], kernel)

        def jpred(cj, data):
            return JA.predict(cj, data, jnp.asarray(Xnew), [jnp.asarray(k) for k in knots], kernel, full_cov=True)

        kt = torch.tensor(knots)[None]

        def tfun(ct, data):
            return TA.elbo(ct, data, kt, kernel)

        def tpred(ct, data):
            return TA.predict(ct, data, torch.tensor(Xnew)[None], kt, kernel, full_cov=True)

    jdata = {"X": jnp.asarray(X), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    cj = {k: jnp.asarray(v) for k, v in c.items()}
    # one jitted program per case: eager JAX compiles every op on its own
    (jval, jgrad), jp = jax.jit(lambda cj_, d: (jax.value_and_grad(jfun)(cj_, d), jpred(cj_, d)))(cj, jdata)
    tdata = {"X": torch.tensor(X)[None], "y": torch.tensor(y)[None], "mask": torch.tensor(mask)[None]}
    ct = {k: torch.tensor(v)[None].requires_grad_(True) for k, v in c.items()}
    tval = tfun(ct, tdata)
    tval.sum().backward()
    _close(tval.detach().numpy()[0], float(jval), RTOL, "elbo")
    for k in c:
        _close(ct[k].grad.numpy()[0], np.asarray(jgrad[k]), GRAD_RTOL, ("grad", k))
    with torch.no_grad():
        tp = tpred({k: v.detach() for k, v in ct.items()}, tdata)
    for k in ("f_mean", "f_var", "y_var", "f_cov"):
        _close(tp[k].numpy()[0], np.asarray(jp[k]), RTOL, k)


def test_kron_and_kvs_match_jax():
    rng = np.random.default_rng(1)
    A, Bm = rng.normal(size=(3, 4)), rng.normal(size=(5, 4))
    np.testing.assert_array_equal(TV.make_kvs([torch.tensor(A)[None], torch.tensor(Bm)[None]])[0].numpy(),
                                  np.asarray(JV.make_kvs([jnp.asarray(A), jnp.asarray(Bm)])))
    P, Q = rng.normal(size=(3, 3)), rng.normal(size=(2, 2))
    np.testing.assert_array_equal(TV.kron([torch.tensor(P)[None], torch.tensor(Q)[None]])[0].numpy(), np.kron(P, Q))


def test_factor_pair_on_the_cpu_is_kernel_1s_plain_version(monkeypatch):
    """P's pair on a CPU tensor reaches kernel 1's wrapper, identity-padded
    to 64, and the wrapper runs its plain version (its launch count stays
    0): the CPU tensor, not a route, chooses the plain version."""
    from gpsat_tpu_torch.ops import block_chol as BC

    calls = []
    plain = BC.factor_blocks_reference
    monkeypatch.setattr(BC, "factor_blocks_reference", lambda Kd: calls.append(tuple(Kd.shape)) or plain(Kd))
    BC.factor_blocks.launches = 0
    X, y, mask, _ = _tile()
    c = {"lengthscales": torch.tensor([[0.8, 1.3]]), "kernel_variance": torch.tensor([1.4]),
         "likelihood_variance": torch.tensor([0.05])}
    data = {"X": torch.tensor(X)[None], "y": torch.tensor(y)[None], "mask": torch.tensor(mask)[None]}
    TV.elbo(c, data, kernel="Matern32", a=torch.tensor([[-2.1, -2.1]]), b=torch.tensor([[2.1, 2.1]]), M=6)
    # (2 M - 1)^2 = 121 features, padded to 128: two 64-blocks
    assert calls == [(1, 64, 64), (1, 64, 64)] and BC.factor_blocks.launches == 0


def test_flop_counts_against_a_hand_count():
    """collapsed_kron_elbo_flops at N = 10, Mtot = 9 (VFF M = 2, D = 2;
    ASVGP Matern32 M = 2, D = 2): 2 N Mtot^2 + 2 N Mtot + 2/3 Mtot^3 +
    2 Mtot^2, counted by hand."""
    hand = 2 * 10 * 81 + 2 * 10 * 9 + 2 * 729 / 3 + 2 * 81
    assert flops.vff_elbo_flops(10, 2, 2) == pytest.approx(hand, rel=1e-15)
    assert flops.asvgp_elbo_flops(10, 2, 2, "Matern32") == pytest.approx(hand, rel=1e-15)
    assert flops.asvgp_elbo_flops(10, 3, 2, "Matern12") == pytest.approx(hand, rel=1e-15)
    assert flops.vff_iter_flops(10, 2, 2) == pytest.approx(3 * hand, rel=1e-15)
    assert flops.asvgp_iter_flops(10, 2, 2, "Matern32") == pytest.approx(3 * hand, rel=1e-15)
    # the shipped config: 361 Fourier features, and ASVGP's 400 / 441 / 484
    assert TV.make_vff_core(num_inducing_features=10).num_features(2) == 361
    assert [TA.make_asvgp_core(k, num_inducing_features=20).num_features(2) for k in TA.SPLINE_PAIRS] == [400, 441, 484]


# --------------------------------------------------------------------------
# per-tile domains and knot grids
# --------------------------------------------------------------------------


def _domain_batch(X, Xnew, expert_loc=None):
    B, N = X.shape[:2]
    return TB.TileBatch(X=X, y=np.sin(X[..., 0]), mask=np.ones((B, N)), Xnew=Xnew, pred_mask=np.ones(Xnew.shape[:2]),
                        obs_mean=np.zeros(B), expert_index=np.arange(B), num_obs=np.full(B, N), expert_loc=expert_loc)


def test_batched_core_matern52_domain_covers_predictions():
    """Port of the JAX test of the same name (tests/test_vff_sklearn.py)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 2.0, (2, 32, 1))
    batch = _domain_batch(X, rng.uniform(3.0, 4.0, (2, 4, 1)))  # outside the data range
    core = TV.make_vff_core(kernel="Matern52", num_inducing_features=8)
    dom = np.asarray(core.prepare_batch_init(batch, core.init_cparams(1))["domain"])  # [B, D, 2]
    assert (dom[..., 0] <= X.min(axis=1)).all()
    assert (dom[..., 1] >= batch.Xnew.max(axis=1)).all()
    # Matern32 keeps the data-derived domain (edge corrections handle
    # outside-domain points)
    core32 = TV.make_vff_core(kernel="Matern32", num_inducing_features=8)
    dom32 = np.asarray(core32.prepare_batch_init(batch, core32.init_cparams(1))["domain"])
    assert (dom32[..., 1] < 3.0).all()


def test_batched_core_domain_centers_on_expert_loc():
    """Port of the JAX test of the same name; and a per-expert domain
    already in the init (loaded, or the fit's own in the polish) is kept,
    only its NaN rows laid over the tile again, and likewise the knots."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, (2, 32, 1))
    eloc = np.array([[0.5], [-0.5]])
    batch = _domain_batch(X, X[:, :4], expert_loc=eloc)
    core = TV.make_vff_core(kernel="Matern32", num_inducing_features=8, domain_size=10.0)
    dom = np.asarray(core.prepare_batch_init(batch, core.init_cparams(1))["domain"])
    # domain = expert +/- domain_size per side (the reference's convention)
    # since the data fit inside
    np.testing.assert_allclose(dom[..., 0], eloc - 10.0)
    np.testing.assert_allclose(dom[..., 1], eloc + 10.0)
    loaded = np.array([[[-3.0, 4.0]], [[np.nan, np.nan]]])
    kept = core.prepare_batch_init(batch, {**core.init_cparams(1), "domain": loaded})["domain"]
    np.testing.assert_array_equal(kept, np.stack([loaded[0], dom[1]]))
    acore = TA.make_asvgp_core(num_inducing_features=5)
    knots = acore.prepare_batch_init(batch, acore.init_cparams(1))["knots"]
    np.testing.assert_allclose(knots[:, 0, 0], X.min(axis=(1, 2)) - 0.1)
    np.testing.assert_allclose(knots[:, 0, -1], X.max(axis=(1, 2)) + 0.1)
    again = acore.prepare_batch_init(batch, {"knots": knots + 1.0})["knots"]
    np.testing.assert_array_equal(again, knots + 1.0)


def test_registry_and_core_rules():
    for name, cls in (("VFFModel", VFFModel), ("GPflowVFFModel", VFFModel), ("ASVGPModel", ASVGPModel),
                      ("GPflowASVGPModel", ASVGPModel)):
        assert get_model(name) is cls
    for jcore, tcore in ((JV.make_vff_core(mean_function="Linear"), TV.make_vff_core(mean_function="Linear")),
                         (JA.make_asvgp_core(kernel="Matern32"), TA.make_asvgp_core(kernel="Matern32"))):
        assert (tcore.name, tuple(tcore.param_names), tuple(tcore.default_fixed_params), tcore.optimizer) == (
            jcore.name, tuple(jcore.param_names), tuple(jcore.default_fixed_params), jcore.optimizer)
    assert VFFModel.param_names == tuple(TV.make_vff_core().param_names)
    assert ASVGPModel.param_names == tuple(TA.make_asvgp_core().param_names)
    # ASVGP defaults to the reference's Matern12, not the engine's Matern32
    assert core_for({}, model_cls=ASVGPModel).name == "asvgp_Matern12"
    assert core_for({"kernel": "Matern52"}, model_cls=VFFModel).name == "vff_Matern52"


# --------------------------------------------------------------------------
# the config through both packages, and the engine on its tile bucket
# --------------------------------------------------------------------------


def _field(n=400, seed=7):
    """A smooth field of n observations on a 1,000 km square (metres), and
    four experts 400 km apart."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 1e6, (n, 2))
    z = np.sin(xy[:, 0] / 2e5) * np.cos(xy[:, 1] / 3e5) + 0.05 * rng.normal(size=n)
    experts = pd.DataFrame({"x": [3e5, 3e5, 7e5, 7e5], "y": [3e5, 7e5, 3e5, 7e5]})
    return pd.DataFrame({"x": xy[:, 0], "y": xy[:, 1], "z": z}), experts


def _config(model: str, src: str, store: str) -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["locations"] = {"source": src, "table": "experts"}
    cfg["data"]["data_source"] = src
    cfg["model"]["oi_model"] = model
    # VFF's f64 fits search with single-eval L-BFGS, not the f64 default
    # zoom: the same optimum at a third of the JAX package's time here.
    # ASVGP's keep zoom: with single-eval the two packages' lengthscales
    # stop 4e-6 apart on its flatter optimum
    if model == "GPflowVFFModel":
        cfg["model"]["optim_kwargs"]["linesearch"] = "single_eval"
    cfg["run_kwargs"]["store_path"] = store
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_run(model: str, tmp: str):
    """The config's model block (VFF, or the same block with
    GPflowASVGPModel) through the JAX package's run_from_config in f64: its
    tables. The JAX orchestrator hands ``domain_size`` to the core without
    dividing it by ``coords_scale`` (the port divides it, as the reference's
    VFFModel does): its copy of the config names the scaled value."""
    from gpsat_tpu.data.store import TableStore as JStore
    from gpsat_tpu.local_expert_oi import run_from_config

    data, experts = _field()
    src = f"{tmp}/field.h5"
    with JStore(src) as s:
        s.put("data", data)
        s.put("experts", experts)
    cfg = _config(model, src, f"{tmp}/jax_{model}.h5")
    ip = cfg["model"]["init_params"]
    ip["domain_size"] = ip["domain_size"] / ip["coords_scale"][0]
    run_from_config(cfg)
    out, _ = jax_results(cfg["run_kwargs"]["store_path"])
    return src, out


@pytest.fixture(scope="module")
def jax_tables(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("vff"))
    return lambda model: _jax_run(model, tmp)


def _by_expert(table, name, width):
    """[E, width] values of one parameter table, experts in (x, y) order."""
    df = table.reset_index().sort_values(["x", "y"] + sorted(c for c in table.reset_index() if c.startswith("_dim_")))
    return df[name].to_numpy().reshape(-1, width)


MODELS = ["GPflowVFFModel", "GPflowASVGPModel"]
PARAM_WIDTHS = {"GPflowVFFModel": {"lengthscales": 2, "kernel_variance": 1, "likelihood_variance": 1, "domain": 4},
                "GPflowASVGPModel": {"lengthscales": 2, "kernel_variance": 1, "likelihood_variance": 1, "knots": 20}}


@pytest.mark.parametrize("model", MODELS, ids=["vff", "asvgp"])
def test_config_through_the_cli_matches_jax(model, jax_tables, tmp_path):
    """configs/example_local_expert_oi_vff.json (VFF Matern32, M = 10: 361
    features; and the same block with GPflowASVGPModel: Matern32, 10 knots,
    121 features) through the port's CLI on the CPU in f64, against the
    JAX tables: predictions and objectives within 1e-8, the per-tile
    domain and knots too, column for column, and the hyperparameters
    within 1e-6 relative (a flat optimum)."""
    from gpsat_tpu_torch import cli

    src, jout = jax_tables(model)
    cfg = _config(model, src, str(tmp_path / "port.h5"))
    cfg["run_kwargs"].update(device="cpu", dtype="float64")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert cli.main(["local_expert_oi", str(path)]) == 0
    tout, configs = port_results(cfg["run_kwargs"]["store_path"])
    assert configs[0]["model"]["oi_model"] == model
    rd, jrd = (o["run_details"].reset_index().sort_values(["x", "y"]) for o in (tout, jout))
    assert len(rd) == 4 and rd["optimise_success"].all() and jrd["optimise_success"].all()
    _close(rd["objective_value"], jrd["objective_value"], PRED_TOL, "objective")
    for name, width in PARAM_WIDTHS[model].items():
        assert list(tout[name].columns) == list(jout[name].columns), name
        tol = PRED_TOL if name in ("domain", "knots") else PARAM_RTOL
        _close(_by_expert(tout[name], name, width), _by_expert(jout[name], name, width), tol, name)
    p, jp = (o["preds"].reset_index().sort_values(["x", "y"]) for o in (tout, jout))
    for col in ("f*", "f*_var", "y_var", "f_bar"):
        _close(p[col], jp[col], PRED_TOL, col)


def _bucket(model: str, src: str):
    """The config's one tile bucket (4 experts, N = 128), as the
    orchestrator assembles it, and the port's core and init for it."""
    from gpsat_tpu_torch.data import select as sel
    from gpsat_tpu_torch.data.prediction_locations import PredictionLocations
    from gpsat_tpu_torch.data.store import TableStore

    with TableStore(src, mode="r") as s:
        data, experts = s.select("data"), s.select("experts")
    cfg = _config(model, src, "unused.h5")
    ip, cons = cfg["model"]["init_params"], cfg["model"]["constraints"]
    ix = sel.local_select_indices_all(data, experts, cfg["data"]["local_select"])
    pcs = PredictionLocations(method="expert_loc", coords_col=["x", "y"]).batch_call(experts)
    (batch,) = TB.assemble_tiles(data[["x", "y"]].to_numpy(), data["z"].to_numpy(), ix, pcs,
                                 expert_locs=experts[["x", "y"]].to_numpy(), coords_scale=ip["coords_scale"],
                                 obs_mean=ip["obs_mean"])
    core = core_for(ip, cons, model_cls=get_model(model))
    return batch, core, initial_cparams(core, ip, cons, 2), experts


@pytest.mark.parametrize("model", MODELS, ids=["vff", "asvgp"])
def test_batched_fit_matches_jax(model, jax_tables):
    """The config's tile bucket (B = 4 experts, N = 128), whose f64 fit
    through the port's engine the CLI test above holds to the JAX
    run_tile_batch results the JAX orchestrator stored for it: here the
    JAX results' parameters, carried across by ``params_from_numpy`` (the
    domain and knots as they are), predict the JAX predictions in the port
    within 1e-8, and the port's f32 fit of the bucket meets the same f64
    gold within 1e-2."""
    src, jout = jax_tables(model)
    batch, core, init, experts = _bucket(model, src)
    order = np.lexsort((experts["y"].to_numpy(), experts["x"].to_numpy()))
    rows = np.argsort(order)[batch.expert_index]  # each tile's rank in (x, y) order
    jp = jout["preds"].reset_index().sort_values(["x", "y"])
    cp = params_from_numpy({n: _by_expert(jout[n], n, w)[rows].reshape((len(rows),) + np.shape(init[n]))
                            for n, w in PARAM_WIDTHS[model].items()}, "cpu", torch.float64)
    data = {"X": torch.tensor(batch.X), "y": torch.tensor(batch.y), "mask": torch.tensor(batch.mask)}
    carried = core.predict(cp, data, torch.tensor(batch.Xnew))
    _close(carried["f_mean"][:, 0].numpy(), jp["f*"].to_numpy()[rows], PRED_TOL, "carried f_mean")
    _close(carried["f_var"][:, 0].numpy(), jp["f*_var"].to_numpy()[rows], PRED_TOL, "carried f_var")

    f32 = TE.run_tile_batch(TB.cast_batch(batch, np.float32), init,
                            TE.make_batched_runner(core, fixed_params=core.default_fixed_params, device="cpu"), core,
                            device="cpu")
    assert f32["f_mean"].dtype == np.float32 and f32["converged"].all()
    assert (f32["expert_index"] == batch.expert_index).all()
    for k, col in (("f_mean", "f*"), ("f_var", "f*_var")):
        _close(f32[k][:, 0], jp[col].to_numpy()[rows], F32_TOL, ("f32", k))
