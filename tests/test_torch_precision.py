"""The port's accumulation precision (gpsat_tpu_torch/ops/precision.py) and
its 3xTF32 product (ops/mm3xtf32.py) on the CPU, against f64 and against
the JAX package's SGPR core run with GPSAT_MM_PRECISION=high.

On the CPU the product runs its plain version (the same split of each f32
operand into tf32 hi and lo, three true-f32 products), and the CPU's XLA
computes f32 dots exactly at either precision, so the JAX core at "high" is
the true-f32 bound: the port at "high" is held to it within f32 roundoff of
the whole bound. One JAX program is compiled (the value and gradient of the
chunked bound, M = 32, N = 512, chunks of 128)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsat_tpu.models import sgpr as JS
from gpsat_tpu_torch import experts as TX
from gpsat_tpu_torch.models import sgpr as TS
from gpsat_tpu_torch.models import svgp as TV
from gpsat_tpu_torch.ops import mm3xtf32 as MM
from gpsat_tpu_torch.ops import precision as PR

CHUNK = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(B=2, N=512, M=32, D=2, seed=0, dtype=np.float32):
    """Masked f32 tiles (the second with 100 padded rows) and their params,
    the inducing points a subset of each tile's valid points."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 5, (B, N, D))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.normal(size=(B, N))
    mask = np.ones((B, N))
    mask[1, -100:] = 0.0
    Z = np.stack([X[b, rng.choice(int(mask[b].sum()), M, replace=False)] for b in range(B)])
    cp = {
        "lengthscales": np.array([[1.0, 1.3], [0.7, 0.9]])[:B],
        "kernel_variance": np.array([0.8, 1.1])[:B],
        "likelihood_variance": np.array([0.05, 0.02])[:B],
        "inducing_points": Z,
    }
    cast = lambda a: np.asarray(a, dtype=dtype)  # noqa: E731
    return cast(X), cast(y), cast(mask), {k: cast(v) for k, v in cp.items()}


def _bound_and_grads(X, y, mask, cp, **kw):
    tc = {k: torch.tensor(v, requires_grad=k != "inducing_points") for k, v in cp.items()}
    td = {"X": torch.tensor(X), "y": torch.tensor(y), "mask": torch.tensor(mask)}
    e = TS.elbo(tc, td, kernel="Matern32", **kw)
    names = ["lengthscales", "kernel_variance", "likelihood_variance"]
    grads = torch.autograd.grad(e.sum(), [tc[k] for k in names])
    return e.detach(), dict(zip(names, grads))


def _products(a_shape, b_shape, ta, tb, seed=1):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal(a_shape).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(b_shape).astype(np.float32))
    exact = torch.matmul(MM._op(a.double(), ta), MM._op(b.double(), tb))
    scale = float(torch.matmul(MM._op(a.double(), ta).abs(), MM._op(b.double(), tb).abs()).max())
    return a, b, exact, scale


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
def test_plain_3xtf32_product_is_f32_accurate(ta, tb):
    # against the f64 product, relative to max (|A||B|): the split leaves
    # ~3 * 2^-22 per product, so the error is of the order of a true-f32
    # product's (held to 3x it) and far below plain TF32's (held to 1/100)
    M, N, K = 70, 90, 300
    a, b, exact, scale = _products((3, K, M) if ta else (3, M, K), (3, N, K) if tb else (3, K, N), ta, tb)
    err = float((MM.mm3xtf32(a, b, ta, tb).double() - exact).abs().max()) / scale
    err_f32 = float((torch.matmul(MM._op(a, ta), MM._op(b, tb)).double() - exact).abs().max()) / scale
    err_tf32 = float((torch.matmul(MM.round_tf32(MM._op(a, ta)).double(), MM.round_tf32(MM._op(b, tb)).double())
                      - exact).abs().max()) / scale
    assert err <= 3 * err_f32 and err <= 1e-2 * err_tf32, (err, err_f32, err_tf32)


def test_round_tf32_is_cvt_rna():
    # to nearest with ties away from zero at 10 mantissa bits, low 13 bits
    # zero; overflow to infinity, infinities and NaN kept
    one_tie = 1.0 + 2.0**-11
    x = torch.tensor([one_tie, -one_tie, 1.0 + 2.0**-11 - 2.0**-23, 3.0, float("inf"), -float("inf"),
                      float("nan"), np.finfo(np.float32).max], dtype=torch.float32)
    got = MM.round_tf32(x)
    want = [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0, float("inf"), -float("inf")]
    assert got[:6].tolist() == want
    assert torch.isnan(got[6]) and got[7] == float("inf")
    assert int((got[:4].view(torch.int32) & 0x1FFF).abs().max()) == 0
    with pytest.raises(TypeError):
        MM.round_tf32(x.double())


def test_backward_runs_the_same_product():
    # d(op(A) op(B)) through MM3xTF32 against f64 autograd, every orientation
    # and the A A^T of the chunk loop (one tensor twice)
    rng = np.random.default_rng(2)
    for ta, tb in [(False, False), (False, True), (True, False), (True, True)]:
        a = torch.from_numpy(rng.standard_normal((2, 40, 50)).astype(np.float32)).requires_grad_(True)
        b = torch.from_numpy(rng.standard_normal((2, 40 if ta else 50, 30) if not tb else
                                                 (2, 30, 40 if ta else 50)).astype(np.float32)).requires_grad_(True)
        out = MM.MM3xTF32.apply(a, b, ta, tb)
        g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
        ga, gb = torch.autograd.grad(out, (a, b), g)
        a2, b2 = a.detach().double().requires_grad_(True), b.detach().double().requires_grad_(True)
        ga2, gb2 = torch.autograd.grad(torch.matmul(MM._op(a2, ta), MM._op(b2, tb)), (a2, b2), g.double())
        for got, want in ((ga, ga2), (gb, gb2)):
            assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max()), (ta, tb)
    A = torch.from_numpy(rng.standard_normal((2, 20, 60)).astype(np.float32)).requires_grad_(True)
    (gA,) = torch.autograd.grad(PR.accum_matmul(A, A, "high", transpose_b=True).sum(), A)
    A2 = A.detach().double().requires_grad_(True)
    (gA2,) = torch.autograd.grad(torch.matmul(A2, A2.transpose(1, 2)).sum(), A2)
    assert float((gA.double() - gA2).abs().max()) <= 1e-5 * float(gA2.abs().max())


def test_accum_precision_levels():
    assert PR.accum_precision() == "highest" and PR.accum_precision("HIGH") == "high"
    with pytest.raises(ValueError, match="accum_precision"):
        PR.accum_precision("medium")
    with pytest.raises(ValueError):
        TS.make_sgpr_core(accum_precision="tf32")
    # another dtype than f32 has no split: a true product at either level
    a = torch.randn(2, 5, 7, dtype=torch.float64)
    b = torch.randn(2, 7, 3, dtype=torch.float64)
    assert torch.equal(PR.accum_matmul(a, b, "high"), torch.matmul(a, b))


def _todays_chunk_terms(Winv, Z, X, ym, m, ls, kv, sigma, kernel: str, level: str = "highest"):
    # the chunk loop's body before the level existed (every product torch.matmul)
    from gpsat_tpu_torch.ops import kernels as K

    Kuf = K.gram(kernel, Z, X, ls, kv) * m[:, None, :]
    A = torch.matmul(Winv, Kuf) / sigma[:, None, None]
    return torch.matmul(A, A.transpose(1, 2)), torch.matmul(A, ym[:, :, None]), torch.sum(ym * ym, dim=-1)


@pytest.mark.parametrize("chunk_size", [None, CHUNK])
def test_highest_is_bit_for_bit_todays_path(chunk_size, monkeypatch):
    X, y, mask, cp = _tiles()
    e, g = _bound_and_grads(X, y, mask, cp, chunk_size=chunk_size, accum_precision="highest")
    with monkeypatch.context() as mp:
        mp.setattr(TS, "_chunk_terms", _todays_chunk_terms)
        e0, g0 = _bound_and_grads(X, y, mask, cp, chunk_size=chunk_size)
    assert torch.equal(e, e0)
    assert all(torch.equal(g[k], g0[k]) for k in g)


def test_high_leaves_the_unchunked_bound_unchanged(monkeypatch):
    # the unchunked call never reaches the relaxed products (as in the JAX
    # core, whose precision applies inside its chunked scan only)
    X, y, mask, cp = _tiles()
    calls = []
    monkeypatch.setattr(MM, "mm3xtf32_reference", lambda *a: calls.append(a) or _fail())
    e, g = _bound_and_grads(X, y, mask, cp, chunk_size=None, accum_precision="high")
    e0, g0 = _bound_and_grads(X, y, mask, cp, chunk_size=None, accum_precision="highest")
    assert not calls
    assert torch.equal(e, e0) and all(torch.equal(g[k], g0[k]) for k in g)


def _fail():
    raise AssertionError("the unchunked bound reached the 3xTF32 product")


def test_high_runs_the_split_in_the_chunk_loop_only(monkeypatch):
    # per chunk and value-and-gradient: W Kuf and A A^T forward, again in the
    # checkpoint's recomputation, and two products each in their backward
    # (dW, dKuf; dA twice): 8; a no-grad evaluation (the predict) 2 per chunk
    X, y, mask, cp = _tiles()
    n_chunks = X.shape[1] // CHUNK
    calls = []
    plain = MM.mm3xtf32_reference
    monkeypatch.setattr(MM, "mm3xtf32_reference", lambda *a: calls.append(1) or plain(*a))
    _bound_and_grads(X, y, mask, cp, chunk_size=CHUNK, accum_precision="high")
    assert len(calls) == 8 * n_chunks
    calls.clear()
    tc = {k: torch.tensor(v) for k, v in cp.items()}
    td = {"X": torch.tensor(X), "y": torch.tensor(y), "mask": torch.tensor(mask)}
    with torch.no_grad():
        TS.predict(tc, td, td["X"][:, :5], kernel="Matern32", chunk_size=CHUNK, accum_precision="high")
    assert len(calls) == 2 * n_chunks


def test_high_chunked_bound_matches_jax_high(monkeypatch):
    # the JAX core reads GPSAT_MM_PRECISION when it traces: set before its
    # first trace in this process (the function below is traced here once)
    monkeypatch.setenv("GPSAT_MM_PRECISION", "high")
    X, y, mask, cp = _tiles()
    e, g = _bound_and_grads(X, y, mask, cp, chunk_size=CHUNK, accum_precision="high")
    e64, _ = _bound_and_grads(*(np.float64(a) for a in (X, y, mask)), {k: np.float64(v) for k, v in cp.items()},
                              chunk_size=CHUNK)
    names = list(g)
    fn = jax.jit(jax.value_and_grad(lambda c, d: JS.elbo(c, d, kernel="Matern32", chunk_size=CHUNK)))
    for b in range(len(X)):
        jc = {k: jnp.asarray(v[b]) for k, v in cp.items()}
        jd = {"X": jnp.asarray(X[b]), "y": jnp.asarray(y[b]), "mask": jnp.asarray(mask[b])}
        val, jg = fn(jc, jd)
        # two f32 programs of 5e2-3e3 nats in other summation orders: the
        # port at "highest" sits 1.2e-6-6.6e-6 of the f64 bound from the JAX
        # one on these tiles, at "high" 7.4e-7-6.1e-6, and its gradients
        # within 6.5e-6 of each one's largest entry at either level: 2e-5
        # and 5e-5 hold both with a margin of 3 to 8
        scale = abs(float(e64[b]))
        assert abs(float(e[b]) - float(val)) <= 2e-5 * scale, (b, float(e[b]), float(val), float(e64[b]))
        for k in names:
            want = np.asarray(jg[k])
            assert float(np.abs(g[k][b].numpy() - want).max()) <= 5e-5 * float(np.abs(want).max()), (b, k)


def test_svgp_collapsed_paths_and_the_orchestrator_carry_the_level(monkeypatch):
    # the SVGP collapsed bound and collapsed_q take the SGPR terms at the
    # level; the orchestrator forwards init_params' accum_precision to the
    # SGPR and SVGP cores as it forwards chunk_size
    X, y, mask, cp = _tiles(M=16)
    calls = []
    plain = MM.mm3xtf32_reference
    monkeypatch.setattr(MM, "mm3xtf32_reference", lambda *a: calls.append(1) or plain(*a))
    td = {"X": torch.tensor(X), "y": torch.tensor(y), "mask": torch.tensor(mask)}
    tc = {k: torch.tensor(v) for k, v in cp.items()}
    q_mu, q_sqrt = TV.collapsed_q(tc, td, kernel="Matern32", chunk_size=CHUNK, accum_precision="high")
    assert calls and torch.isfinite(q_mu).all() and torch.isfinite(q_sqrt).all()
    q0, _ = TV.collapsed_q(tc, td, kernel="Matern32", chunk_size=CHUNK)
    assert float((q_mu - q0).abs().max()) <= 1e-3 * float(q0.abs().max())
    for model in ("GPflowSGPRModel", "GPflowSVGPModel"):
        calls.clear()
        core = TX.make_core_for_model(
            TX.get_model(model), "Matern32", None,
            {"num_inducing_points": 16, "chunk_size": CHUNK, "accum_precision": "high"})
        u = core.inverse({**tc, "inducing_mean": torch.zeros(2, 16), "inducing_chol": torch.eye(16).expand(2, 16, 16)}
                         if model == "GPflowSVGPModel" else tc)
        with torch.no_grad():
            assert torch.isfinite(core.objective(u, td)).all()
        assert len(calls) == 2 * (X.shape[1] // CHUNK), model

