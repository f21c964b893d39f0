"""The port's factor routes of the fused LML, its profiled-variance LML and
the profiled GPR core end to end (gpsat_tpu_torch/ops/fused_lml.py,
models/gpr.py, models/functional.py, parallel/engine.py) against the JAX
functions they replace, in f64 on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpsat_tpu.models import gpr as JG
from gpsat_tpu.models.functional import make_gpr_core as jax_make_gpr_core
from gpsat_tpu.ops import transforms as JT
from gpsat_tpu.ops import fused_lml as JF
from gpsat_tpu.ops import linalg as JLA
from gpsat_tpu.parallel import batching as JB
from gpsat_tpu.parallel import engine as JE
from gpsat_tpu_torch.convert import batch_from_numpy, params_from_numpy
from gpsat_tpu_torch.models import gpr as TG
from gpsat_tpu_torch.models.functional import make_gpr_core
from gpsat_tpu_torch.ops import fused_lml as TF
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import transforms as TT
from gpsat_tpu_torch.parallel import engine as TE

JITTER = 1e-5
NAMES = ("y", "ls", "var", "noise")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, N, nvalid, seed=2, D=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, D))
    y = np.sin(X[..., 0]) + 0.1 * rng.standard_normal((B, N))
    m = np.ones((B, N))
    m[:, nvalid:] = 0
    ls = rng.uniform(0.6, 1.9, (B, D))
    kv = rng.uniform(0.5, 1.5, B)
    lv = rng.uniform(0.01, 0.2, B)
    return X, y, m, ls, kv, lv


def _torch_value_and_grads(fn, args, diff=(1, 3, 4, 5)):
    ts = [torch.from_numpy(a) for a in args]
    leaves = [ts[i].requires_grad_(True) for i in diff]
    val = fn(*ts)
    # White's Gram never reads the lengthscales: their gradient is zero
    grads = torch.autograd.grad(val.sum(), leaves, allow_unused=True)
    return val.detach().numpy(), [np.zeros(x.shape) if g is None else g.numpy() for x, g in zip(leaves, grads)]


def _assert_close(val, grads, val_ref, grads_ref, names, tol=1e-9, msg=""):
    np.testing.assert_allclose(val, val_ref, rtol=tol, err_msg=msg)
    for g, gr, name in zip(grads, grads_ref, names):
        np.testing.assert_allclose(g, gr, rtol=tol, atol=tol * np.abs(gr).max(), err_msg=f"{msg} d/d{name}")


def test_all_factor_routes_match_jax_fused_lml_f64():
    # N=256: two 128-blocks for the panel route, four 64-blocks for the block
    # route, one split of the recursion. f64: the same math through four
    # factorisations, equal to roundoff; 1e-9 leaves room for the Gram's
    # cancellation near the diagonal
    args = _inputs(B=2, N=256, nvalid=200)

    def jf(X, y, m, ls, kv, lv):
        return JF.masked_gpr_lml_fused("Matern32", X, y, m, ls, kv, lv, JITTER)

    val_j, grads_j = jax.vmap(jax.value_and_grad(jf, argnums=(1, 3, 4, 5)))(*(jnp.asarray(a) for a in args))
    for factor in LA.FACTOR_ROUTES:
        val, grads = _torch_value_and_grads(
            lambda *a: TF.masked_gpr_lml_fused("Matern32", *a, JITTER, factor), args
        )
        _assert_close(val, grads, np.asarray(val_j), [np.asarray(g) for g in grads_j], NAMES, msg=factor)
    with pytest.raises(ValueError):
        TF.masked_gpr_lml_fused("Matern32", *(torch.from_numpy(a) for a in args), JITTER, "lapack")


def test_autodiff_lml_matches_fused_and_jax():
    # ops/linalg.masked_gpr_lml differentiates through the Cholesky's own
    # backward; both of its quadratic-form arms against the JAX function
    # (value) and the fused analytic gradients
    args = _inputs(B=2, N=64, nvalid=50, seed=3)
    X, y, m, ls, kv, lv = args
    want = np.stack(
        [np.asarray(JLA.masked_gpr_lml(*(jnp.asarray(a[b]) for a in args), kernel="Matern32", jitter=JITTER)) for b in range(2)]
    )
    val_f, grads_f = _torch_value_and_grads(lambda *a: TF.masked_gpr_lml_fused("Matern32", *a, JITTER, "recursive"), args)
    for fast in (False, True):
        val, grads = _torch_value_and_grads(
            lambda *a: LA.masked_gpr_lml(*a, kernel="Matern32", jitter=JITTER, fast_inverse=fast), args
        )
        np.testing.assert_allclose(val, want, rtol=1e-10)
        _assert_close(val, grads, val_f, grads_f, NAMES, msg=f"fast_inverse={fast}")


def test_profiled_lml_matches_jax_f64():
    # value, gradients (y, lengthscales, tau) and sigma2_hat against the JAX
    # functions called directly, with one all-masked lane (the engine's batch
    # padding): value 0, sigma2 1, zero gradients there
    X, y, m, ls, _, tau = _inputs(B=3, N=128, nvalid=100, seed=4)
    m[2] = 0.0
    args = (X, y, m, ls, tau)

    def jf(X, y, m, ls, tau):
        return JF.masked_gpr_lml_profiled("Matern32", X, y, m, ls, tau, JITTER)

    jargs = [jnp.asarray(a) for a in args]
    val_j, grads_j = jax.vmap(jax.value_and_grad(jf, argnums=(1, 3, 4)))(*jargs)
    sig_j = jax.vmap(lambda *a: JF.profiled_sigma2("Matern32", *a, JITTER))(*jargs)

    val, grads = _torch_value_and_grads(
        lambda *a: TF.masked_gpr_lml_profiled("Matern32", *a, JITTER), args, diff=(1, 3, 4)
    )
    _assert_close(val, grads, np.asarray(val_j), [np.asarray(g) for g in grads_j], ("y", "ls", "tau"))
    assert val[2] == 0.0 and all(np.all(g[2] == 0.0) for g in grads)
    sig = TF.profiled_sigma2("Matern32", *(torch.from_numpy(a) for a in args), JITTER).numpy()
    np.testing.assert_allclose(sig, np.asarray(sig_j), rtol=1e-9)
    assert sig[2] == 1.0

    # lml_profiled(ls, tau) == lml_joint(ls, sigma2_hat, tau * sigma2_hat)
    joint = TF.masked_gpr_lml_fused(
        "Matern32", *(torch.from_numpy(a) for a in (X, y, m, ls, sig, tau * sig)), JITTER * float(sig[0]), "cholesky"
    )
    np.testing.assert_allclose(val[0], joint.numpy()[0], rtol=1e-9)


AUTODIFF_KERNELS = ("RationalQuadratic", "Cosine", "White")


def _jax_profiled_value_and_grads(kernel, X, y, m, ls, tau):
    """JAX's neg_lml_profiled tile by tile, run eagerly (no compile of a
    whole program): value and gradients w.r.t. (y, lengthscales, tau)."""
    bij = {k: JT.IDENTITY for k in ("lengthscales", "kernel_variance", "likelihood_variance")}

    def f(y_b, ls_b, tau_b, X_b, m_b):
        u = {"lengthscales": ls_b, "kernel_variance": jnp.ones_like(tau_b), "likelihood_variance": tau_b}
        return JG.neg_lml_profiled(u, {"X": X_b, "y": y_b, "mask": m_b}, kernel=kernel, bijectors=bij, jitter=JITTER)

    out = [jax.value_and_grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a[b]) for a in (y, ls, tau, X, m)))
           for b in range(len(X))]
    return np.array([float(v) for v, _ in out]), [np.stack([np.asarray(g[i]) for _, g in out]) for i in range(3)]


def _torch_profiled(kernel, X, y, m, ls, tau):
    bij = {k: TT.IDENTITY for k in ("lengthscales", "kernel_variance", "likelihood_variance")}

    def f(X, y, m, ls, tau):
        u = {"lengthscales": ls, "kernel_variance": torch.ones_like(tau), "likelihood_variance": tau}
        return TG.neg_lml_profiled(u, {"X": X, "y": y, "mask": m}, kernel=kernel, bijectors=bij, jitter=JITTER)

    return _torch_value_and_grads(f, (X, y, m, ls, tau), diff=(1, 3, 4))


@pytest.mark.parametrize("kernel", AUTODIFF_KERNELS)
def test_autodiff_profiled_objective_matches_jax_f64(kernel):
    # the kernels outside FUSED_KERNELS take the autodiff form through
    # ops/cholesky's backward (kernel 3 on the card in f32). f64, value and
    # gradients (y, lengthscales, tau) within 1e-10 of the JAX function, N =
    # 96 (off the 128-block, so the CPU takes the library factor there as on
    # the card), with one all-masked lane: value 0 and zero gradients
    # gradients to 1e-10 of the objective's size: White's objective does not
    # depend on tau (A = (tau + jitter) I cancels against sigma2_hat), so its
    # tau gradient is roundoff on both sides
    X, y, m, ls, _, tau = _inputs(B=3, N=96, nvalid=80, seed=5)
    m[2] = 0.0
    val_j, grads_j = _jax_profiled_value_and_grads(kernel, X, y, m, ls, tau)
    val, grads = _torch_profiled(kernel, X, y, m, ls, tau)
    np.testing.assert_allclose(val, val_j, rtol=1e-10, err_msg=kernel)
    for g, gr, name in zip(grads, grads_j, ("y", "ls", "tau")):
        np.testing.assert_allclose(g, gr, rtol=1e-10, atol=1e-10 * np.abs(val_j).max(), err_msg=f"{kernel} d/d{name}")
    assert val[2] == 0.0 and all(np.all(g[2] == 0.0) for g in grads)
    assert np.all(np.isfinite(val))


@pytest.mark.parametrize("kernel", AUTODIFF_KERNELS)
def test_autodiff_profiled_sigma2_identity(kernel):
    # lml_profiled(ls, tau) == lml_joint(ls, sigma2_hat, tau * sigma2_hat),
    # the joint side JAX's neg_lml with the jitter scaled as in A (K = sigma2
    # A): 1e-10 relative. The JAX package's own sigma2_hat (its finalize)
    # takes the fused kernels only, so the identity is the oracle here
    X, y, m, ls, _, tau = _inputs(B=2, N=64, nvalid=56, seed=6)
    t = [torch.from_numpy(a) for a in (X, y, m, ls, tau)]
    sig = TF.profiled_sigma2(kernel, *t, JITTER).numpy()
    val, _ = _torch_profiled(kernel, X, y, m, ls, tau)
    bij = {k: JT.IDENTITY for k in ("lengthscales", "kernel_variance", "likelihood_variance")}
    for b in range(2):
        u = {"lengthscales": jnp.asarray(ls[b]), "kernel_variance": jnp.asarray(sig[b]),
             "likelihood_variance": jnp.asarray(tau[b] * sig[b])}
        joint = JG.neg_lml(u, {"X": jnp.asarray(X[b]), "y": jnp.asarray(y[b]), "mask": jnp.asarray(m[b])},
                           kernel=kernel, bijectors=bij, jitter=JITTER * float(sig[b]))
        np.testing.assert_allclose(val[b], float(joint), rtol=1e-10, err_msg=kernel)
    empty = np.zeros_like(m)
    assert np.all(TF.profiled_sigma2(kernel, *t[:2], torch.from_numpy(empty), *t[3:], JITTER).numpy() == 1.0)


@pytest.mark.parametrize("kernel", AUTODIFF_KERNELS)
def test_profiled_core_fits_and_predicts_autodiff_kernels(kernel):
    # make_gpr_core(kernel, profile_variance=True) end to end on the port's
    # engine (f64, CPU): finalize maps tau back through sigma2_hat, so the
    # joint objective at the reported (kv, lv) equals the profiled objective
    # at the optimum (1e-9 relative; the JAX package's finalize raises for
    # these kernels), and the predictions are finite. jitter 0, so that
    # sigma2_hat's A and the joint K = sigma2_hat A carry the same diagonal
    rng = np.random.default_rng(7)
    Bt, Nt, Pt = 3, 64, 4
    X = rng.uniform(-3, 3, (Bt, Nt, 2))
    y = np.sin(X[..., 0]) + 0.1 * rng.normal(size=(Bt, Nt))
    mask = np.ones((Bt, Nt))
    mask[1, 50:] = 0.0
    batch = JB.TileBatch(X=X, y=y, mask=mask, Xnew=rng.uniform(-2, 2, (Bt, Pt, 2)), pred_mask=np.ones((Bt, Pt)),
                         obs_mean=np.zeros(Bt), expert_index=np.arange(Bt), num_obs=mask.sum(1).astype(int))
    init = {"lengthscales": np.ones((Bt, 2)), "kernel_variance": np.ones(Bt), "likelihood_variance": 0.1 * np.ones(Bt)}
    core = make_gpr_core(kernel=kernel, profile_variance=True)
    runner = TE.make_batched_runner(core, fixed_params=core.default_fixed_params, linesearch="single_eval",
                                    max_iter=100, device="cpu", **TOLS)
    res = TE.run_tile_batch(batch_from_numpy(batch), init, runner, core, device="cpu")
    assert not res["failed"].any(), kernel
    for k in ("f_mean", "f_var", "y_var"):
        assert np.isfinite(res[k]).all(), (kernel, k)
    assert (res["f_var"] >= -1e-9).all()
    cp = {k: torch.from_numpy(np.asarray(res[k], dtype=np.float64)) for k in core.param_names}
    data = {k: torch.from_numpy(getattr(batch, k)) for k in ("X", "y", "mask")}
    bij = {k: TT.IDENTITY for k in core.param_names}
    sig = cp["kernel_variance"]
    with torch.no_grad():
        joint = TG.neg_lml(cp, data, kernel=kernel, bijectors=bij, jitter=0.0)
        prof = TG.neg_lml_profiled({**cp, "likelihood_variance": cp["likelihood_variance"] / sig}, data,
                                   kernel=kernel, bijectors=bij, jitter=0.0)
    np.testing.assert_allclose(joint.numpy(), prof.numpy(), rtol=1e-9, err_msg=kernel)


# --------------------------------------------------------------------------
# the slice as a whole: the profiled core through both engines
# --------------------------------------------------------------------------

B, N, P, D = 8, 128, 4, 2
TOLS = dict(tol_grad=1e-6, tol_f=1e-11)


def _jax_batch():
    rng = np.random.default_rng(0)
    X = rng.uniform(-6, 6, (B, N, D))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))
    mask = np.ones((B, N))
    fill = rng.integers(int(0.7 * N), N + 1, size=B)
    for i, f in enumerate(fill):
        mask[i, f:] = 0.0
    Xnew = rng.uniform(-4, 4, (B, P, D))
    batch = JB.TileBatch(
        X=X, y=y, mask=mask, Xnew=Xnew, pred_mask=np.ones((B, P)),
        obs_mean=np.zeros(B), expert_index=np.arange(B), num_obs=fill,
    )
    var_y = np.nanvar(np.where(mask > 0, y, np.nan), axis=1)
    init = {
        "lengthscales": np.nanstd(np.where(mask[..., None] > 0, X, np.nan), axis=1),
        "kernel_variance": var_y,
        "likelihood_variance": 0.1 * var_y,
    }
    return batch, init


@pytest.fixture(scope="module")
def runs():
    """One JAX runner compile and run of the profiled core, and the port on
    the same batch, both with the fused LML in f64 and single-eval L-BFGS."""
    batch, init = _jax_batch()
    JLA.set_fast_inverse(True)
    try:
        core = jax_make_gpr_core(profile_variance=True)
        runner = JE.make_batched_runner(
            core, fixed_params=core.default_fixed_params, linesearch="single_eval", max_iter=200, **TOLS
        )
        ref = JE.run_tile_batch(batch, init, runner, core)
    finally:
        JLA.set_fast_inverse(None)
    tcore = make_gpr_core(profile_variance=True)
    trunner = TE.make_batched_runner(
        tcore, fixed_params=tcore.default_fixed_params, linesearch="single_eval", max_iter=200, device="cpu", **TOLS
    )
    got = TE.run_tile_batch(batch_from_numpy(batch), init, trunner, tcore, device="cpu")
    return batch, ref, got


def test_profiled_slice_f64_matches_jax_engine(runs):
    _, ref, got = runs
    assert tuple(make_gpr_core(profile_variance=True).default_fixed_params) == ("kernel_variance",)
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    assert not got["failed"].any()
    # both stop on |df| <= 1e-11 |f| near a flat optimum, where f carries
    # ~1e-12 of roundoff from the factorisation and the sums: on about half
    # the lanes that test fires some iterations apart (the port earlier).
    # Lanes with equal iteration counts followed the same trajectory and are
    # held to roundoff; the others to the flat optimum's own band (seen:
    # 2e-7 relative on parameters, 4e-8 on predictions)
    same = got["num_iter"] == ref["num_iter"]
    assert same.sum() >= B // 2, (got["num_iter"], ref["num_iter"])
    assert np.abs(got["num_iter"] - ref["num_iter"]).max() <= 10, (got["num_iter"], ref["num_iter"])
    for k in ("lengthscales", "kernel_variance", "likelihood_variance"):
        rel = (np.abs(got[k] - ref[k]) / np.abs(ref[k])).reshape(B, -1).max(1)
        assert rel[same].max() <= 1e-8, (k, rel)
        assert rel.max() <= 2e-6, (k, rel)
    for k in ("f_mean", "f_var", "y_var"):
        err = np.abs(got[k] - ref[k]).max(1)
        assert err[same].max() <= 1e-10, (k, err)
        assert err.max() <= 5e-7, (k, err)
    np.testing.assert_allclose(got["objective"], ref["objective"], rtol=1e-9)


def test_profiled_params_carry_over_and_predict_only_reports_joint_objective(runs):
    # the JAX result is in the standard (kernel_variance, likelihood_variance)
    # parameterisation: converted as is, it gives JAX's predictions, and a
    # predict-only run of the profiled core reports the JOINT objective there,
    # which equals the profiled objective at the optimum the JAX run reported
    batch, ref, _ = runs
    tcore = make_gpr_core(profile_variance=True)
    cp = params_from_numpy({k: ref[k] for k in tcore.param_names}, "cpu", torch.float64)
    data = {k: torch.from_numpy(getattr(batch, k)) for k in ("X", "y", "mask")}
    with torch.no_grad():
        pred = tcore.predict(cp, data, torch.from_numpy(batch.Xnew))
    for k in ("f_mean", "f_var", "y_var"):
        np.testing.assert_allclose(pred[k].numpy(), ref[k], rtol=0, atol=1e-9, err_msg=k)

    runner = TE.make_batched_runner(
        tcore, fixed_params=tcore.default_fixed_params, optimise=False, linesearch="single_eval", device="cpu"
    )
    init = {k: ref[k] for k in tcore.param_names}
    res = TE.run_tile_batch(batch_from_numpy(batch), init, runner, tcore, device="cpu")
    for k in tcore.param_names:  # loaded params are honoured verbatim: no device_init, no finalize
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-12, err_msg=k)
    # the JAX profiled objective scales the jitter by sigma2_hat (A carries
    # jitter, K = sigma2 A); the joint objective adds it unscaled. jitter is
    # 0 here, so the two agree to roundoff
    np.testing.assert_allclose(res["objective"], ref["objective"], rtol=1e-9)
    with torch.no_grad():
        wrong = tcore.objective(tcore.inverse(cp), data).numpy()
    assert np.abs(wrong - ref["objective"]).max() > 1e-3  # the profiled objective would misread the lv slot
