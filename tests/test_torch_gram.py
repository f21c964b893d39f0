"""The port's Gram for all nine kernel names (gpsat_tpu_torch/ops/kernels.py)
and the GPR objective and predict (models/gpr.py) for the kernels outside
the fused set (RationalQuadratic, Cosine, White), against the JAX functions
they replace, in f64 on the same numpy inputs. The JAX objective runs one
tile at a time under vmap, jitted once per kernel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpsat_tpu.models import gpr as JGPR
from gpsat_tpu.ops import kernels as JK
from gpsat_tpu.ops import transforms as JT
from gpsat_tpu_torch.models import gpr as TGPR
from gpsat_tpu_torch.ops import kernels as TK
from gpsat_tpu_torch.ops import transforms as TT
from gpsat_tpu_torch.ops.fused_lml import FUSED_KERNELS

B, N, D, P = 2, 16, 2, 5
NT, NVALID = 64, (64, 41)  # the tiles of the objective and predict: the block route takes N a multiple of 64
AUTODIFF_KERNELS = ("RationalQuadratic", "Cosine", "White")
NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(seed=5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (B, NT, D))
    y = np.sin(X[..., 0]) * np.cos(X[..., 1]) + 0.1 * rng.standard_normal((B, NT))
    mask = np.zeros((B, NT))
    for b, n in enumerate(NVALID):
        mask[b, :n] = 1.0
    cparams = {
        "lengthscales": np.array([[0.9, 1.7], [2.3, 1.2]]),
        "kernel_variance": np.array([0.8, 1.6]),
        "likelihood_variance": np.array([0.1, 0.25]),
    }
    Xnew = rng.uniform(-2, 2, (B, P, D))
    return {"X": X, "y": y, "mask": mask}, cparams, Xnew


def test_kernel_names_match_jax():
    assert TK.KERNEL_NAMES == JK.KERNEL_NAMES
    assert set(FUSED_KERNELS) | set(AUTODIFF_KERNELS) == set(TK.KERNEL_NAMES)


@pytest.mark.parametrize("kernel", JK.KERNEL_NAMES)
def test_gram_matches_jax_for_every_kernel(kernel):
    # f64, one tile at a time through JAX; the same formulas (the squared
    # distance in its matmul form, Cosine's signed sum of scaled differences)
    rng = np.random.default_rng(3)
    X1, X2 = rng.uniform(-3, 3, (B, N, D)), rng.uniform(-3, 3, (B, 9, D))
    ls, var = np.array([[0.7, 1.6], [1.1, 0.9]]), np.array([0.8, 1.7])
    got = TK.gram(kernel, *(torch.from_numpy(a) for a in (X1, X2, ls, var))).numpy()
    want = np.stack([np.asarray(JK.gram(kernel, X1[b], X2[b], ls[b], var[b])) for b in range(B)])
    assert got.shape == (B, N, 9)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kernel", AUTODIFF_KERNELS)
def test_neg_lml_value_and_gradient_match_jax(kernel):
    # the port's neg_lml takes the autodiff LML for these kernels, as the
    # JAX package does: f64 through other Cholesky routes, equal to ~1e-12
    # relative; 1e-9 as for the fused LML's f64 test
    data, cparams, _ = _tiles()
    uparams = {k: np.asarray(TT.POSITIVE.inverse(torch.from_numpy(v))) for k, v in cparams.items()}

    def jfun(u, d):
        return JGPR.neg_lml(u, d, kernel=kernel, bijectors={k: JT.POSITIVE for k in NAMES}, jitter=1e-8)

    val_j, grad_j = jax.jit(jax.vmap(jax.value_and_grad(jfun)))(
        {k: jnp.asarray(v) for k, v in uparams.items()}, {k: jnp.asarray(v) for k, v in data.items()})

    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in uparams.items()}
    val_t = TGPR.neg_lml(leaves, {k: torch.from_numpy(v) for k, v in data.items()}, kernel=kernel,
                         bijectors={k: TT.POSITIVE for k in NAMES}, jitter=1e-8)
    grads = torch.autograd.grad(val_t.sum(), list(leaves.values()), allow_unused=True)
    np.testing.assert_allclose(val_t.detach().numpy(), np.asarray(val_j), rtol=1e-9)
    for name, g in zip(leaves, grads):
        g = np.zeros_like(uparams[name]) if g is None else g.numpy()  # White's Gram ignores ls and kv
        gj = np.asarray(grad_j[name])
        np.testing.assert_allclose(g, gj, rtol=1e-9, atol=1e-9 * max(np.abs(gj).max(), 1.0), err_msg=name)


@pytest.mark.parametrize("kernel", AUTODIFF_KERNELS)
def test_predict_matches_jax(kernel):
    data, cparams, Xnew = _tiles(seed=7)
    got = TGPR.predict({k: torch.from_numpy(v) for k, v in cparams.items()},
                       {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(Xnew), kernel=kernel)
    for b in range(B):
        want = JGPR.predict({k: jnp.asarray(v[b]) for k, v in cparams.items()},
                            {k: jnp.asarray(v[b]) for k, v in data.items()}, jnp.asarray(Xnew[b]), kernel=kernel)
        for key in ("f_mean", "f_var", "y_var"):
            np.testing.assert_allclose(got[key][b].numpy(), np.asarray(want[key]), rtol=1e-9, atol=1e-12,
                                       err_msg=f"{key}, tile {b}")
