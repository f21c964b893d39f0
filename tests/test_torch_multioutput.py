"""The port's multi-output models (gpsat_tpu_torch/models/multioutput/)
against the JAX package's (gpsat_tpu/models/multioutput/core.py), in f64 on
the same numpy inputs, on the CPU. JAX runs eagerly except for four
compiled programs: the exact LML's and the ELBO's values and gradients,
and inside its two classes' fits the zoom L-BFGS loop and the Adam step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpsat_tpu.models.multioutput as JM
import gpsat_tpu_torch.models.multioutput as TM

H2 = np.array([[1.0, 0.5], [0.2, 1.0]])
KERNEL = "Matern32"
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float64))


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()), err_msg=msg)


def _mixed(n=40, seed=1, noise=0.02):
    """Two latents seen through H2, sorted 1-d inputs (tests/test_multioutput.py)."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 10, n))[:, None]
    F = np.stack([np.sin(X[:, 0]), np.cos(X[:, 0] / 2.0)], axis=1)
    return X, F @ H2.T + noise * rng.normal(size=(n, 2)), F


def _gpr_params(likelihood_variance):
    return {"lengthscales": np.array([[1.3], [2.1]]), "kernel_variances": np.array([0.8, 1.4]),
            "likelihood_variance": np.asarray(likelihood_variance)}


@pytest.mark.parametrize("lv", [0.01, [0.01, 0.03]], ids=["scalar_R", "per_output_R"])
def test_gpr_functions_match_jax(lv):
    # latent_gram (latents as the batch), observed_cov's [N, P, M, Q] order,
    # the noise tiling of a scalar and a [P] variance, the LML and the
    # latent predictions, 1e-10 relative; the LML's gradient too for the
    # [P] variance (one compiled JAX program; the scalar case runs eagerly,
    # values only)
    import jax

    X, Y, _ = _mixed()
    Xs = np.linspace(0, 10, 7)[:, None]
    p = _gpr_params(lv)
    cj = {k: _j(v) for k, v in p.items()}
    ct = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    Kj = JM.latent_gram(_j(X), _j(Xs), cj["lengthscales"], cj["kernel_variances"], KERNEL)
    Kt = TM.latent_gram(_t(X), _t(Xs), ct["lengthscales"], ct["kernel_variances"], KERNEL)
    _close(Kt, Kj, msg="latent_gram")
    _close(TM.observed_cov(Kt, _t(H2)), JM.observed_cov(Kj, _j(H2)), msg="observed_cov")

    def jax_side(c):
        lml = JM.mo_gpr_lml(c, _j(X), _j(Y), _j(H2), kernel=KERNEL)
        return lml, JM.mo_gpr_predict(c, _j(X), _j(Y), _j(H2), _j(Xs), kernel=KERNEL)

    lml_t = TM.mo_gpr_lml(ct, _t(X), _t(Y), _t(H2), kernel=KERNEL)
    if np.ndim(lv):
        (lml_j, (mj, vj)), g_j = jax.jit(jax.value_and_grad(jax_side, has_aux=True))(cj)
        g_t = torch.autograd.grad(lml_t, list(ct.values()))
        for (k, g) in zip(ct, g_t):
            _close(g, g_j[k], msg=f"d mo_gpr_lml / d {k}")
    else:
        lml_j, (mj, vj) = jax_side(cj)
    _close(lml_t, lml_j, msg="mo_gpr_lml")
    mt, vt = TM.mo_gpr_predict(ct, _t(X), _t(Y), _t(H2), _t(Xs), kernel=KERNEL)
    _close(mt, mj, msg="predict mean")
    _close(vt, vj, msg="predict var")


def _svgp_params(X, L=2, M=12, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "inducing_points": X[rng.choice(len(X), M, replace=False)],
        "lengthscales": rng.uniform(0.8, 2.0, (L, 1)),
        "kernel_variances": rng.uniform(0.5, 1.5, L),
        "likelihood_variance": np.asarray(0.05),
        "q_mu": rng.normal(size=(L, M)),
        # a full (not lower-triangular) matrix: kl_whitened and the
        # marginals read its lower triangle only
        "q_sqrt": np.eye(M)[None] * 0.5 + 0.05 * rng.normal(size=(L, M, M)),
    }


def test_svgp_elbo_matches_jax():
    # the ELBO and its gradient w.r.t. every param (the L Kuu pairs in one
    # batched call), 1e-10 relative
    import jax

    X, Y, _ = _mixed(n=50, seed=2)
    p = _svgp_params(X)
    cj = {k: _j(v) for k, v in p.items()}
    ct = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    ej, gj = jax.jit(jax.value_and_grad(lambda c: JM.mo_svgp_elbo(c, _j(X), _j(Y), _j(H2), kernel=KERNEL)))(cj)
    et = TM.mo_svgp_elbo(ct, _t(X), _t(Y), _t(H2), kernel=KERNEL)
    gt = torch.autograd.grad(et, list(ct.values()))
    _close(et, ej, msg="mo_svgp_elbo")
    for k, g in zip(ct, gt):
        _close(g, gj[k], msg=f"d elbo / d {k}")


def test_gaussian_helpers_match_jax():
    # multivariate_gaussian_log_density (batched, broadcast cov),
    # add_likelihood_noise_cov and multioutput_conditional (full and
    # marginal covariance, L = P = 2): 1e-10 relative
    rng = np.random.default_rng(4)
    x, mu = rng.normal(size=(3, 4, 2)), rng.normal(size=(3, 4, 2))
    A = rng.normal(size=(2, 2))
    cov = A @ A.T + 0.5 * np.eye(2)
    _close(TM.multivariate_gaussian_log_density(x, mu, cov), JM.multivariate_gaussian_log_density(x, mu, cov))
    K4 = rng.normal(size=(3, 3, 2, 2))
    R = np.array([[0.5, 0.1], [0.1, 0.4]])
    _close(TM.add_likelihood_noise_cov(K4, R), JM.add_likelihood_noise_cov(K4, R))

    M, N, L = 5, 3, 2
    Xm, Xn = rng.uniform(0, 5, (M, 1)), rng.uniform(0, 5, (N, 1))
    ls = np.array([[1.0], [2.0]])
    kv = np.array([1.0, 0.7])

    def block(A_, B_):  # [M, L, N, L] Matern32 Grams, latents independent
        out = np.zeros((len(A_), L, len(B_), L))
        for l in range(L):
            r = np.sqrt(3.0) * np.abs(A_[:, None, 0] - B_[None, :, 0]) / ls[l, 0]
            out[:, l, :, l] = kv[l] * (1.0 + r) * np.exp(-r)
        return out

    Kmn, Kmm, Knn = block(Xm, Xn), block(Xm, Xm), block(Xn, Xn)
    f = rng.normal(size=(M, 2))
    for full in (True, False):
        knn = Knn if full else np.stack([Knn[i, :, i, :] for i in range(N)])
        mt, vt = TM.multioutput_conditional(Kmn, Kmm, knn, f, H2, R, full_cov=full)
        mj, vj = JM.multioutput_conditional(Kmn, Kmm, knn, f, H2, R, full_cov=full)
        _close(mt, mj, msg=f"conditional mean, full_cov={full}")
        _close(vt, vj, msg=f"conditional var, full_cov={full}")


def test_linear_likelihood_closed_forms():
    # the JAX test's hand values (tests/test_multioutput.py), 1e-12
    # absolute, and the port against JAX's class on random inputs, 1e-10
    lik = TM.LinearModelLikelihood(input_dim=2, variance=0.1, forward_model=np.array([[0.5, 0.5]]))
    f, fmu, fvar = np.array([[1.0, 1.0]]), np.array([[1.0, 1.0]]), np.eye(2)[None]
    X, y = np.array([[0.5, 0.5]]), np.array([[1.0]])
    np.testing.assert_allclose(lik.conditional_mean(X, f), [[1.0]], atol=1e-12)
    np.testing.assert_allclose(lik.conditional_variance(X, f), [[0.1]], atol=1e-12)
    mu, var = lik.predict_mean_and_var(X, fmu, fvar)
    np.testing.assert_allclose(mu, [[1.0]], atol=1e-12)
    np.testing.assert_allclose(var, [[[0.6]]], atol=1e-12)
    np.testing.assert_allclose(lik.predict_log_density(X, fmu, fvar, y), [-0.5 * np.log(2 * np.pi * 0.6)], atol=1e-10)
    np.testing.assert_allclose(lik.variational_expectations(X, fmu, fvar, y),
                               [-0.5 * np.log(2 * np.pi * 0.1) - 0.5 * (0.5 / 0.1)], atol=1e-10)

    rng = np.random.default_rng(5)
    H = rng.normal(size=(3, 2))
    R = np.diag([0.2, 0.3, 0.4])
    X = rng.normal(size=(4, 2))
    F, Y = rng.normal(size=(4, 2)), rng.normal(size=(4, 3))
    A = rng.normal(size=(4, 2, 2))
    Fcov = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(2)
    lt = TM.LinearModelLikelihood(input_dim=2, variance=R, forward_model=TM.LinearForwardModel(2, 2, 3, H))
    lj = JM.LinearModelLikelihood(input_dim=2, variance=R, forward_model=H)
    _close(lt.log_prob(X, F, Y), lj.log_prob(X, F, Y), msg="log_prob")
    _close(lt.variance_at(X), lj.variance_at(X), msg="variance_at")
    _close(lt.conditional_variance(X, F), lj.conditional_variance(X, F), msg="conditional_variance")
    for a, b in zip(lt.predict_mean_and_var(X, F, Fcov), lj.predict_mean_and_var(X, F, Fcov)):
        _close(a, b, msg="predict_mean_and_var")
    _close(lt.predict_log_density(X, F, Fcov, Y), lj.predict_log_density(X, F, Fcov, Y), msg="predict_log_density")
    _close(lt.variational_expectations(X, F, Fcov, Y), lj.variational_expectations(X, F, Fcov, Y), msg="ve")


def test_nonlinear_monte_carlo_matches_linear_closed_form():
    # the JAX test's setting and tolerance (20,000 draws, 0.1 absolute);
    # the draws come from a torch.Generator seeded by `seed`, so two calls
    # agree exactly
    H = np.array([[0.7, -0.3], [0.1, 0.9]])
    lin = TM.LinearModelLikelihood(input_dim=2, variance=0.2, forward_model=H)
    mc = TM.NonlinearModelLikelihood(TM.LinearForwardModel(2, 2, 2, H), variance=0.2, num_samples=20000, seed=3)
    rng = np.random.default_rng(0)
    fmu = rng.normal(size=(4, 2))
    A = rng.normal(size=(4, 2, 2)) * 0.3
    fvar = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(2)
    X, y = rng.normal(size=(4, 2)), rng.normal(size=(4, 2))
    got = mc.variational_expectations(X, fmu, fvar, y)
    np.testing.assert_allclose(got, lin.variational_expectations(X, fmu, fvar, y), atol=0.1)
    assert torch.equal(got, mc.variational_expectations(X, fmu, fvar, y))
    assert isinstance(mc.h, TM.ForwardModel) and mc.latent_dim == 2 and mc.observation_dim == 2


def test_gpr_model_fit_matches_jax():
    # MultioutputGPRModel: the objective at the start within 1e-10, then
    # both fits by zoom L-BFGS (max_iter 100) to the same optimum: params
    # and predictions within 1e-6
    X, Y, _ = _mixed(n=40, seed=1)
    Xs = np.linspace(0, 10, 9)[:, None]
    tm = TM.MultioutputGPRModel(coords=X, obs=Y, H=H2, likelihood_variance=0.02**2, device="cpu")
    jm = JM.MultioutputGPRModel(coords=X, obs=Y, H=H2, likelihood_variance=0.02**2)
    np.testing.assert_allclose(tm.get_objective_function_value(), jm.get_objective_function_value(), rtol=TOL)
    assert tm.optimise_parameters(max_iter=100) == jm.optimise_parameters(max_iter=100) is True
    for k in jm._params:
        np.testing.assert_allclose(tm._params[k], jm._params[k], rtol=1e-6, err_msg=k)
    pt, pj = tm.predict(Xs), jm.predict(Xs)
    for k in ("f*", "f*_var"):
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_svgp_model_adam_matches_jax():
    # MultioutputSVGPModel: the same inducing draw, then 40 Adam steps
    # (optax.adam in JAX, engine.adam_update here) step for step: params,
    # ELBO and predictions within 1e-10. M = 8: JAX's f64 marginals solve
    # with Kuu's factor, the port multiplies by its inverse, and Adam's
    # normalised steps carry that cond(Kuu) eps roundoff on; with 10 to 16
    # inducing points on these 60 points the params drift 1e-10 to 6e-9
    # apart in 40 steps, with 8 they stay 1e-12 apart
    X, Y, _ = _mixed(n=60, seed=2, noise=0.05)
    kw = dict(coords=X, obs=Y, H=H2, num_inducing_points=8, likelihood_variance=0.05, seed=4)
    tm, jm = TM.MultioutputSVGPModel(**kw, device="cpu"), JM.MultioutputSVGPModel(**kw)
    np.testing.assert_array_equal(tm._params["inducing_points"], jm._params["inducing_points"])
    assert tm.optimise_parameters(max_iter=40, learning_rate=0.03) and jm.optimise_parameters(max_iter=40,
                                                                                              learning_rate=0.03)
    for k in jm._params:
        np.testing.assert_allclose(tm._params[k], jm._params[k], rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(tm.get_objective_function_value(), jm.get_objective_function_value(), rtol=TOL)
    pt, pj = tm.predict(X[:7]), jm.predict(X[:7])
    for k in ("f*", "f*_var"):
        np.testing.assert_allclose(pt[k], pj[k], rtol=TOL, atol=TOL, err_msg=k)


def test_device_default_is_the_card():
    # without device= the classes ask for CUDA, which this machine lacks
    X, Y, _ = _mixed(n=10)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.MultioutputGPRModel(coords=X, obs=Y, H=H2)


def test_legacy_import_paths():
    # every name the JAX package exports, and the reference's three
    # submodule paths
    import gpsat_tpu_torch.models.multioutput.gpr as G
    import gpsat_tpu_torch.models.multioutput.likelihoods as Lk
    import gpsat_tpu_torch.models.multioutput.utils as U

    assert set(TM.__all__) == set(JM.__all__)
    for name in JM.__all__:
        assert hasattr(TM, name), name
    for mod, jmod in ((G, "gpr"), (Lk, "likelihoods"), (U, "utils")):
        import importlib

        want = importlib.import_module(f"gpsat_tpu.models.multioutput.{jmod}").__all__
        assert mod.__all__ == want
        for name in want:
            assert getattr(mod, name) is getattr(TM, name), (jmod, name)
    assert TM.MultioutputGPR is TM.MultioutputGPRModel and TM.MultioutputSVGP is TM.MultioutputSVGPModel
