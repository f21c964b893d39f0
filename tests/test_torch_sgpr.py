"""The port's SGPR core (gpsat_tpu_torch/models/sgpr.py) against the JAX
package's (gpsat_tpu/models/sgpr.py) on the CPU, in f64 unless named.

The bound, its gradient in every parameter and the predictions are held at
1e-8 relative: the JAX package solves with ``cholesky`` + ``tri_solve`` in
f64, the port multiplies by W = L^-1 from the factor pair, so the two agree
at f64 roundoff, not bit for bit. One JAX runner is compiled (the batched
fit at B=4, N=128, M=32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsat_tpu.models import sgpr as JS
from gpsat_tpu.parallel import engine as JE
from gpsat_tpu.parallel.batching import TileBatch as JTileBatch
from gpsat_tpu_torch.convert import batch_from_numpy
from gpsat_tpu_torch.models import SGPRModel, get_model
from gpsat_tpu_torch.models import sgpr as TS
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.parallel import engine as TE

RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_oi.py: six pytest workers
    share the machine's cores in the tier-1 run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(B=3, N=100, M=16, D=2, seed=0):
    """Masked tiles: full, 30 rows padded, and 10 valid rows whose inducing
    set is far-point padded (more slots than points)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 5, (B, N, D))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))
    mask = np.ones((B, N))
    mask[1, -30:] = 0.0
    mask[2, 10:] = 0.0
    Z = np.stack([X[b, rng.choice(int(mask[b].sum()), M, replace=False)] if mask[b].sum() >= M
                  else TS.pad_inducing_points(X[b, : int(mask[b].sum())], M, data_span=6.0) for b in range(B)])
    cp = {
        "lengthscales": np.array([[1.0, 1.3], [0.7, 0.9], [1.5, 2.0]])[:B],
        "kernel_variance": np.array([0.8, 1.1, 0.5])[:B],
        "likelihood_variance": np.array([0.05, 0.02, 0.1])[:B],
        "inducing_points": Z,
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


@pytest.mark.parametrize("kernel", ["Matern32", "Matern52", "RBF"])
def test_elbo_and_its_gradient_match_jax(kernel):
    X, y, mask, cp = _tiles()
    tc, td = _port(X, y, mask, cp)
    e = TS.elbo(tc, td, kernel=kernel)
    e.sum().backward()
    for b in range(len(X)):
        jc, jd = _jax_tile(X, y, mask, cp, b)
        _close(float(e[b].detach()), float(JS.elbo(jc, jd, kernel=kernel)), what="elbo")
        g = jax.grad(lambda c: JS.elbo(c, jd, kernel=kernel))(jc)
        for k in cp:
            _close(tc[k].grad[b].numpy(), g[k], what=(b, k))


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_matches_jax(full_cov):
    X, y, mask, cp = _tiles()
    Xn = np.random.default_rng(5).uniform(0, 5, (len(X), 7, 2))
    tc, td = _port(X, y, mask, cp, grad=False)
    got = TS.predict(tc, td, torch.tensor(Xn), kernel="Matern32", full_cov=full_cov)
    assert ("f_cov" in got) == full_cov
    for b in range(len(X)):
        jc, jd = _jax_tile(X, y, mask, cp, b)
        want = JS.predict(jc, jd, jnp.asarray(Xn[b]), kernel="Matern32", full_cov=full_cov)
        for k in want:
            _close(got[k][b].numpy(), want[k], what=(b, k))


def test_constant_mean_matches_jax():
    X, y, mask, cp = _tiles()
    cp = {**cp, "mean_c": np.array([0.3, -1.0, 2.0])}
    y = y + cp["mean_c"][:, None]
    tc, td = _port(X, y, mask, cp)
    e = TS.elbo(tc, td, kernel="Matern32")
    e.sum().backward()
    Xn = np.random.default_rng(6).uniform(0, 5, (len(X), 5, 2))
    with torch.no_grad():
        pred = TS.predict(tc, td, torch.tensor(Xn), kernel="Matern32")
    for b in range(len(X)):
        jc, jd = _jax_tile(X, y, mask, cp, b)
        _close(float(e[b].detach()), float(JS.elbo(jc, jd, kernel="Matern32")), what="elbo")
        g = jax.grad(lambda c: JS.elbo(c, jd, kernel="Matern32"))(jc)
        _close(tc["mean_c"].grad[b].numpy(), g["mean_c"], what="mean_c")
        want = JS.predict(jc, jd, jnp.asarray(Xn[b]), kernel="Matern32")
        _close(pred["f_mean"][b].numpy(), want["f_mean"], what="f_mean")


@pytest.mark.parametrize("chunk_remat", [True, False])
def test_chunked_equals_unchunked(chunk_remat):
    """tests/test_sgpr.py's inputs: N = 700 (not a chunk multiple), 37 rows
    masked, M = 32, chunks of 128."""
    rng = np.random.default_rng(0)
    N, M, D = 700, 32, 2
    X = rng.uniform(0, 5, (N, D))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=N)
    mask = np.ones(N)
    mask[-37:] = 0.0
    Z = X[rng.choice(N, M, replace=False)]
    cp = {"lengthscales": np.array([[1.0, 1.3]]), "kernel_variance": np.array([0.8]),
          "likelihood_variance": np.array([0.05]), "inducing_points": Z[None]}
    Xn = torch.tensor(rng.uniform(0, 5, (1, 9, D)))
    out = []
    for chunk in (None, 128):
        tc, td = _port(X[None], y[None], mask[None], cp)
        e = TS.elbo(tc, td, kernel="Matern32", chunk_size=chunk, chunk_remat=chunk_remat)
        e.sum().backward()
        with torch.no_grad():
            p = TS.predict(tc, td, Xn, kernel="Matern32", chunk_size=chunk)
        out.append((float(e[0].detach()), {k: v.grad.numpy() for k, v in tc.items()}, p))
    (e0, g0, p0), (e1, g1, p1) = out
    _close(e1, e0, rtol=1e-10, what="elbo")
    for k in g0:
        _close(g1[k], g0[k], rtol=1e-10, what=k)
    for k in p0:
        _close(p1[k].numpy(), p0[k].numpy(), rtol=1e-10, what=k)
    # and the same value as the JAX package's chunked bound
    jc = {k: jnp.asarray(v[0]) for k, v in cp.items()}
    jd = {"X": jnp.asarray(X), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    _close(e1, float(JS.elbo(jc, jd, kernel="Matern32", chunk_size=128)), what="jax chunked")


def test_checkpointed_chunks_do_not_recompute_the_factor_pairs(monkeypatch):
    """The pair of Kuu sits outside the chunk loop: a backward through
    checkpointed chunks factors nothing again (two pairs per evaluation)."""
    calls = []
    pair = LA.chol_winv_padded

    def counted(*a, **k):
        calls.append(1)
        return pair(*a, **k)

    monkeypatch.setattr(LA, "chol_winv_padded", counted)
    X, y, mask, cp = _tiles(N=300)
    tc, td = _port(X, y, mask, cp)
    TS.elbo(tc, td, kernel="Matern32", chunk_size=64).sum().backward()
    assert len(calls) == 2
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in tc.values())


def _jax_batch(B=5, N=128, M=32, seed=2):
    """B tiles with 120-128 valid rows, one with fewer rows than M and one
    dead (mask all-zero)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, 2))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.05 * rng.normal(size=(B, N))
    n = rng.integers(120, N + 1, size=B)
    n[1], n[-1] = M // 2, 0
    mask = (np.arange(N)[None, :] < n[:, None]).astype(float)
    P = 16
    return JTileBatch(X=X, y=y, mask=mask, Xnew=rng.uniform(-2, 2, (B, P, 2)), pred_mask=np.ones((B, P)),
                      obs_mean=np.zeros(B), expert_index=np.where(n > 0, np.arange(B), -1), num_obs=n)


def test_prepare_batch_init_draws_the_jax_packages_inducing_points():
    jb = _jax_batch()
    want = JS.make_sgpr_core(num_inducing_points=32).prepare_batch_init(jb, {})["inducing_points"]
    core = TS.make_sgpr_core(num_inducing_points=32)
    got = core.prepare_batch_init(batch_from_numpy(jb), {})["inducing_points"]
    np.testing.assert_array_equal(got, want)
    # per-expert values are kept; a row with a NaN (nothing loaded) is drawn
    given = np.full_like(got, 7.0)
    given[2] = np.nan
    out = core.prepare_batch_init(batch_from_numpy(jb), {"inducing_points": given})["inducing_points"]
    np.testing.assert_array_equal(out[2], want[2])
    assert (np.delete(out, 2, axis=0) == 7.0).all()


def test_f32_inducing_pads_stay_finite():
    """M = 2N in f32: the far pads must not cost the Kuu factor its diagonal
    (the JAX package's tests/test_sgpr.py case)."""
    rng = np.random.default_rng(0)
    B, N, P = 2, 48, 4
    X = rng.uniform(-6, 6, (B, N, 2)).astype(np.float32)
    batch = batch_from_numpy(JTileBatch(
        X=X, y=(np.sin(X[..., 0]) * np.cos(X[..., 1])).astype(np.float32), mask=np.ones((B, N), np.float32),
        Xnew=rng.uniform(-4, 4, (B, P, 2)).astype(np.float32), pred_mask=np.ones((B, P), np.float32),
        obs_mean=np.zeros(B, np.float32), expert_index=np.arange(B), num_obs=np.full(B, N)))
    core = TS.make_sgpr_core(jitter=1e-5, num_inducing_points=96)
    runner = TE.make_batched_runner(core, fixed_params=core.default_fixed_params, max_iter=60, device="cpu")
    res = TE.run_tile_batch(batch, {"smart_init": True}, runner, core, device="cpu")
    assert np.isfinite(res["objective"]).all() and np.isfinite(res["f_mean"]).all()
    assert res["converged"].all()


@pytest.fixture(scope="module")
def batched_fits():
    jb = _jax_batch()
    kw = dict(max_iter=200, linesearch="single_eval", tol_grad=1e-6, tol_f=1e-11)
    jcore = JS.make_sgpr_core(num_inducing_points=32)
    jres = JE.run_tile_batch(jb, {"smart_init": True},
                             JE.make_batched_runner(jcore, fixed_params=("inducing_points",), **kw), jcore)
    core = TS.make_sgpr_core(num_inducing_points=32)
    tres = TE.run_tile_batch(batch_from_numpy(jb), {"smart_init": True},
                             TE.make_batched_runner(core, fixed_params=core.default_fixed_params, device="cpu", **kw),
                             core, device="cpu")
    return jres, tres


@pytest.mark.parametrize("key", ["f_mean", "f_var", "lengthscales", "kernel_variance", "likelihood_variance",
                                 "inducing_points", "objective"])
def test_batched_fit_matches_jax(batched_fits, key):
    jres, tres = batched_fits
    np.testing.assert_array_equal(tres["expert_index"], jres["expert_index"])
    assert tres["converged"].all() and np.asarray(jres["converged"]).all()
    if key in ("f_mean", "f_var"):
        np.testing.assert_allclose(tres[key], jres[key], rtol=0, atol=1e-6)
    else:
        # a flat f64 optimum: the two stop an iteration or so apart
        np.testing.assert_allclose(tres[key], jres[key], rtol=1e-6, atol=1e-9)


def test_registry_and_core_options():
    assert get_model("GPflowSGPRModel") is SGPRModel and get_model("SGPRModel") is SGPRModel
    assert "inducing_points" in SGPRModel.param_names
    # SVGP, VFF and ASVGP resolve since they were ported, and the host-serial
    # lane's models since it was
    assert get_model("GPflowSVGPModel").__name__ == "SVGPModel"
    assert get_model("GPflowVFFModel").__name__ == "VFFModel"
    assert get_model("GPflowASVGPModel").__name__ == "ASVGPModel"
    assert get_model("sklearnGPRModel").__name__ == "SklearnGPRModel"
    assert get_model("GPyTorchGPRModel").__name__ == "TorchGPRModel"
    with pytest.raises(ValueError):
        TS.make_sgpr_core(factor="panel")
    core = TS.make_sgpr_core(num_inducing_points=8, train_inducing_points=True, mean_function="Constant")
    assert core.default_fixed_params == () and core.param_names[-1] == "mean_c"
    assert TS.make_sgpr_core().name == "SGPR[Matern32,M=500]"
