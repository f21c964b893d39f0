"""The port's fused masked-GPR LML (gpsat_tpu_torch/ops/fused_lml.py), its
Gram construction and its transforms, against the JAX functions they
replace, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpsat_tpu.ops import kernels as JK
from gpsat_tpu.ops import transforms as JT
from gpsat_tpu.ops.fused_lml import masked_gpr_lml_fused as jax_lml
from gpsat_tpu_torch.ops import kernels as TK
from gpsat_tpu_torch.ops import transforms as TT
from gpsat_tpu_torch.ops.fused_lml import masked_gpr_lml_fused

B, N, D, NVALID = 3, 128, 2, 100
JITTER = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dtype, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, N, D)).astype(dtype)
    y = (np.sin(X[..., 0]) + 0.1 * rng.standard_normal((B, N))).astype(dtype)
    m = np.ones((B, N), dtype)
    m[:, NVALID:] = 0
    ls = np.stack([np.full(D, 1.3), np.full(D, 0.8), np.array([0.6, 1.9])]).astype(dtype)
    kv = np.array([0.9, 1.4, 0.5], dtype)
    lv = np.array([0.05, 0.2, 0.01], dtype)
    return X, y, m, ls, kv, lv


def _jax_value_and_grads(args):
    def f(X, y, m, ls, kv, lv):
        return jax_lml("Matern32", X, y, m, ls, kv, lv, JITTER)

    vg = jax.vmap(jax.value_and_grad(f, argnums=(1, 3, 4, 5)))
    val, grads = vg(*(jnp.asarray(a) for a in args))
    return np.asarray(val), [np.asarray(g) for g in grads]


def _torch_value_and_grads(args):
    X, y, m, ls, kv, lv = (torch.from_numpy(a) for a in args)
    leaves = [t.requires_grad_(True) for t in (y, ls, kv, lv)]
    val = masked_gpr_lml_fused("Matern32", X, y, m, ls, kv, lv, JITTER)
    grads = torch.autograd.grad(val.sum(), leaves)
    return val.detach().numpy(), [g.numpy() for g in grads]  # order: y, ls, kv, lv


def test_fused_lml_f64_matches_jax():
    # f64 against JAX's default (plain Cholesky + solve) route: the same
    # math through other factorisations, equal to ~1e-12 relative; 1e-9
    # leaves room for the Gram's cancellation near the diagonal
    args = _inputs(np.float64)
    val_j, grads_j = _jax_value_and_grads(args)
    val_t, grads_t = _torch_value_and_grads(args)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-9)
    for gt, gj, name in zip(grads_t, grads_j, ("y", "ls", "kv", "lv")):
        np.testing.assert_allclose(gt, gj, rtol=1e-9, atol=1e-9 * np.abs(gj).max(), err_msg=name)


def test_fused_lml_f32_matches_jax_block_path(monkeypatch):
    # f32 against JAX's diagonal-block route (the Pallas kernel in interpret
    # mode), with tests/test_block_chol.py's tolerances for that route:
    # rtol 1e-5 on the value, atol 5e-5 on max-scaled gradients
    monkeypatch.setenv("GPSAT_BLOCK_CHOL", "force")
    monkeypatch.setenv("GPSAT_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    try:
        args = _inputs(np.float32)
        val_j, grads_j = _jax_value_and_grads(args)
    finally:
        monkeypatch.setenv("GPSAT_BLOCK_CHOL", "0")
        jax.clear_caches()
    val_t, grads_t = _torch_value_and_grads(args)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-5, atol=1e-3)
    for gt, gj, name in zip(grads_t, grads_j, ("y", "ls", "kv", "lv")):
        scale = max(float(np.abs(gj).max()), 1.0)
        np.testing.assert_allclose(gt / scale, gj / scale, rtol=0, atol=5e-5, err_msg=name)


def test_fused_lml_refuses_grad_for_X():
    X, y, m, ls, kv, lv = (torch.from_numpy(a) for a in _inputs(np.float64))
    with pytest.raises(ValueError):
        masked_gpr_lml_fused("Matern32", X.requires_grad_(True), y, m, ls, kv, lv)


@pytest.mark.parametrize("kernel", ["Matern12", "Matern32", "Matern52", "RBF"])
def test_gram_matches_jax(kernel):
    # f64, one tile at a time through JAX; the same matmul-form distance
    rng = np.random.default_rng(3)
    X1, X2 = rng.uniform(-3, 3, (2, 17, D)), rng.uniform(-3, 3, (2, 9, D))
    ls, var = np.array([[0.7, 1.6], [1.1, 0.9]]), np.array([0.8, 1.7])
    got = TK.gram(kernel, *(torch.from_numpy(a) for a in (X1, X2, ls, var))).numpy()
    want = np.stack([np.asarray(JK.gram(kernel, X1[b], X2[b], ls[b], var[b])) for b in range(2)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_transforms_match_jax():
    # softplus round trip incl. the eps-threshold branches, and the
    # interval bijector's +-40 clip
    y = np.array([1e-20, 1e-9, 0.3, 2.0, 40.0, 1e5])
    np.testing.assert_allclose(
        TT.inverse_softplus(torch.from_numpy(y)).numpy(), np.asarray(JT.inverse_softplus(jnp.asarray(y))), rtol=1e-13
    )
    x = np.linspace(-50, 50, 11)
    np.testing.assert_allclose(TT.softplus(torch.from_numpy(x)).numpy(), np.asarray(JT.softplus(jnp.asarray(x))), rtol=1e-13)
    tb, jb = TT.interval(0.1, 5.0), JT.interval(0.1, 5.0)
    v = np.array([0.1, 0.2, 2.5, 4.99, 5.0, 7.0])
    np.testing.assert_allclose(tb.inverse(torch.from_numpy(v)).numpy(), np.asarray(jb.inverse(jnp.asarray(v))), rtol=1e-12)
    np.testing.assert_allclose(tb.forward(torch.from_numpy(x)).numpy(), np.asarray(jb.forward(jnp.asarray(x))), rtol=1e-13)
