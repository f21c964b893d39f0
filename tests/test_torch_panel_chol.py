"""The port's 128-block factor pair (gpsat_tpu_torch/ops/panel_chol.py) and
the blocked factorisation built on it (ops/linalg.chol_panels_batched,
tri_inv_from_diag, tri_solve_from_diag) against the Pallas kernel and the
JAX functions they replace, and against numpy.

On the CPU, ``factor_panels`` runs its plain PyTorch version; the CUDA
kernel itself is checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpsat_tpu.ops import linalg as JLA
from gpsat_tpu.ops.pallas.panel_chol import factor_panels as pallas_factor_panels
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops import panel_chol as PC

T = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd_blocks(B, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, T, T)).astype(dtype)
    return A @ np.swapaxes(A, 1, 2) + T * np.eye(T, dtype=dtype)


def test_reference_matches_pallas_kernel():
    # same f32 inputs through the Pallas kernel (interpret mode) and the
    # port's plain version of the CUDA kernel; the JAX package's own test
    # holds the Pallas kernel to numpy at these tolerances (L entries are
    # O(10), 128 dependent f32 steps in other summation orders)
    K = _spd_blocks(3, seed=0)
    Lp, Ip = (np.asarray(a) for a in pallas_factor_panels(jnp.asarray(K), interpret=True))
    L, Inv = (a.numpy() for a in PC.factor_panels(torch.from_numpy(K)))
    np.testing.assert_allclose(L, Lp, rtol=0, atol=2e-4)
    np.testing.assert_allclose(Inv, Ip, rtol=0, atol=2e-5)
    np.testing.assert_allclose(L @ Inv, np.broadcast_to(np.eye(T), K.shape), rtol=0, atol=2e-5)
    assert np.all(np.triu(L, 1) == 0.0) and np.all(np.triu(Inv, 1) == 0.0)


def test_reference_f64_matches_numpy():
    K = _spd_blocks(2, seed=1, dtype=np.float64)
    L, Inv = (a.numpy() for a in PC.factor_panels(torch.from_numpy(K)))
    np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=0, atol=1e-10)
    np.testing.assert_allclose(L @ Inv, np.broadcast_to(np.eye(T), K.shape), rtol=0, atol=1e-10)


def test_zero_pivot_is_clamped_like_the_pallas_kernel():
    # the contract is the 1e-30 clamp: an all-zero block gives finite values
    # (L = 1e-15 I, Linv = 1e15 I), the identity block beside it is exact
    K = np.stack([np.zeros((T, T), np.float32), np.eye(T, dtype=np.float32)])
    Lp, Ip = (np.asarray(a) for a in pallas_factor_panels(jnp.asarray(K), interpret=True))
    L, Inv = (a.numpy() for a in PC.factor_panels(torch.from_numpy(K)))
    assert np.isfinite(L).all() and np.isfinite(Inv).all()
    np.testing.assert_allclose(L, Lp, rtol=1e-6, atol=0)
    np.testing.assert_allclose(Inv, Ip, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(L[1], np.eye(T, dtype=np.float32))


def test_factor_panels_rejects_bad_shapes_and_counts_no_cpu_launch():
    with pytest.raises(ValueError):
        PC.factor_panels(torch.zeros(2, 64, 64))
    with pytest.raises(ValueError):
        PC.factor_panels(torch.zeros(128, 128))
    before = PC.factor_panels.launches
    PC.factor_panels(torch.from_numpy(_spd_blocks(1, seed=2)))
    assert PC.factor_panels.launches == before  # the counter counts kernel launches only


def test_blocked_factor_and_diag_helpers_match_jax():
    # N=256 (two 128-blocks), f64: the port's plain block version vs JAX's
    # LAPACK factor fed to the same JAX helpers; same algebra, other
    # summation orders, so 1e-10 absolute on O(1) entries
    rng = np.random.default_rng(3)
    B, N = 2, 256
    A = rng.standard_normal((B, N, N)) / np.sqrt(N)
    K = A @ np.swapaxes(A, 1, 2) + np.eye(N)
    b = rng.standard_normal((B, N, 2))

    Lj, Wdj = jax.vmap(JLA._chol_panel_pair_unbatched)(jnp.asarray(K))
    Wj = jax.vmap(JLA.tri_inv_from_diag)(Lj, Wdj)
    vj = jax.vmap(JLA.tri_solve_from_diag)(Lj, Wdj, jnp.asarray(b))

    L, Wdiag = LA.chol_panels_batched(torch.from_numpy(K))
    assert tuple(Wdiag.shape) == (B, N // T, T, T)
    W = LA.tri_inv_from_diag(L, Wdiag)
    v = LA.tri_solve_from_diag(L, Wdiag, torch.from_numpy(b))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Wdiag.numpy(), np.asarray(Wdj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    # a width off the 128-block is identity-padded, and the pad sliced away
    L1, Wd1 = LA.chol_panels_batched(torch.eye(192, dtype=torch.float64)[None])
    assert L1.shape == (1, 192, 192) and Wd1.shape == (1, 2, 128, 128)
    assert torch.equal(L1[0], torch.eye(192, dtype=torch.float64))
    assert torch.equal(Wd1[0], torch.eye(128, dtype=torch.float64).expand(2, 128, 128))


# The CUDA kernel runs a blocked order (32-column panels, the inverse by
# sub-diagonals of 32x32 blocks); its plain PyTorch emulation runs here and
# is held to the contract, factor_panels_reference, which the test above
# holds to the Pallas kernel.


def test_blocked_emulation_f64_matches_reference():
    # the same algebra in another order: roundoff of f64 on O(10) entries
    K = torch.from_numpy(_spd_blocks(2, seed=4, dtype=np.float64))
    L, Inv = PC.factor_panels_blocked_emulation(K)
    Lr, Ir = PC.factor_panels_reference(K)
    np.testing.assert_allclose(L.numpy(), Lr.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Inv.numpy(), Ir.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [5, 6])
def test_blocked_emulation_f32_within_the_kernel_bounds(seed):
    # the bounds the card holds the kernel to: 2e-4 on L (entries O(10)),
    # 2e-5 on Linv and on L Linv - I
    K = torch.from_numpy(_spd_blocks(3, seed=seed))
    L, Inv = PC.factor_panels_blocked_emulation(K)
    Lr, Ir = PC.factor_panels_reference(K)
    assert float((L - Lr).abs().max()) <= 2e-4
    assert float((Inv - Ir).abs().max()) <= 2e-5
    LW = np.matmul(L.numpy().astype(np.float64), Inv.numpy().astype(np.float64))
    np.testing.assert_allclose(LW, np.broadcast_to(np.eye(T), LW.shape), rtol=0, atol=2e-5)
    assert np.all(np.triu(L.numpy(), 1) == 0.0) and np.all(np.triu(Inv.numpy(), 1) == 0.0)


def test_blocked_emulation_keeps_the_clamp():
    # an all-zero block: every pivot is clamped (L = 1e-15 I, Linv = 1e15 I);
    # the identity block beside it comes back exactly
    K = torch.stack([torch.zeros(T, T), torch.eye(T)])
    L, Inv = PC.factor_panels_blocked_emulation(K)
    Lr, Ir = PC.factor_panels_reference(K)
    assert torch.isfinite(L).all() and torch.isfinite(Inv).all()
    assert torch.allclose(L, Lr, rtol=1e-6, atol=0) and torch.allclose(Inv, Ir, rtol=1e-6, atol=0)
    assert torch.equal(L[1], torch.eye(T)) and torch.equal(Inv[1], torch.eye(T))
    with pytest.raises(ValueError):
        PC.factor_panels_blocked_emulation(torch.zeros(1, 96, 96), nb=64)


def test_blocked_emulation_rsqrt_pivot_is_kernel_3s_rule():
    # kernel 3's pivot rule (r = rsqrt(a_jj), L_jj = a_jj r, no clamp) on the
    # same blocked order: on SPD blocks in f64 the same factor and inverse as
    # the plain version to roundoff (1e-10 on O(10) entries); a zero or
    # negative block gives NaN where the clamp gives finite values; the
    # identity block comes back exactly
    K = torch.from_numpy(_spd_blocks(2, seed=7, dtype=np.float64))
    L, Inv = PC.factor_panels_blocked_emulation(K, pivot="rsqrt")
    Lr, Ir = PC.factor_panels_reference(K)
    np.testing.assert_allclose(L.numpy(), Lr.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Inv.numpy(), Ir.numpy(), rtol=0, atol=1e-10)
    odd = torch.stack([torch.zeros(T, T), -torch.eye(T), torch.eye(T)])
    L, Inv = PC.factor_panels_blocked_emulation(odd, pivot="rsqrt")
    assert torch.isnan(L[0]).any() and torch.isnan(L[1]).any() and torch.isnan(Inv[1]).any()
    assert torch.equal(L[2], torch.eye(T)) and torch.equal(Inv[2], torch.eye(T))
    with pytest.raises(ValueError):
        PC.factor_panels_blocked_emulation(odd, pivot="sqrt")
