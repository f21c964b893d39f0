"""The port's diagonal-block factor pair (gpsat_tpu_torch/ops/block_chol.py
and ops/linalg.chol_winv_batched) against the Pallas kernel it replaces and
against numpy.

On the CPU, ``factor_blocks`` runs its plain PyTorch version; the CUDA
kernel itself is checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpsat_tpu.ops.pallas.block_chol import factor_blocks as pallas_factor_blocks
from gpsat_tpu_torch.ops import block_chol as BC
from gpsat_tpu_torch.ops.linalg import chol_winv_batched

T = 64


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


@pytest.fixture(scope="module")
def pallas_pair():
    """f32 inputs and the Pallas kernel's (L, W) on them, in interpret mode
    (one call for the whole file)."""
    K = _spd_blocks(7, seed=0)
    Lp, Wp = (np.asarray(a) for a in pallas_factor_blocks(jnp.asarray(K), interpret=True))
    return K, Lp, Wp


def test_reference_matches_pallas_kernel(pallas_pair):
    # same f32 inputs through the Pallas kernel (interpret mode) and the
    # port's plain version of the CUDA kernel. atol 2e-5: both run the same
    # 64 f32 steps, in other summation orders; L entries are O(10).
    K, Lp, Wp = pallas_pair
    L, W = (a.numpy() for a in BC.factor_blocks(torch.from_numpy(K)))
    np.testing.assert_allclose(L, Lp, rtol=0, atol=2e-5)
    np.testing.assert_allclose(W, Wp, rtol=0, atol=2e-5)
    assert np.all(np.triu(L, 1) == 0.0) and np.all(np.triu(W, 1) == 0.0)


def test_blocked_emulation_matches_pallas_kernel(pallas_pair):
    # the CUDA kernel's blocked order (2x2 blocks of 32, rsqrt pivot, the
    # inverse by blocks) on the same f32 inputs: the same bound, 2e-5, for
    # the same reason (f32 roundoff in other orders on O(10) entries)
    K, Lp, Wp = pallas_pair
    L, W = (a.numpy() for a in BC.factor_blocks_blocked_emulation(torch.from_numpy(K)))
    np.testing.assert_allclose(L, Lp, rtol=0, atol=2e-5)
    np.testing.assert_allclose(W, Wp, rtol=0, atol=2e-5)
    assert np.all(np.triu(L, 1) == 0.0) and np.all(np.triu(W, 1) == 0.0)


def test_blocked_emulation_f64_matches_reference():
    # f64: the blocked order and the 64-step loop are the same factor, equal
    # to roundoff
    K = torch.from_numpy(_spd_blocks(5, seed=3, dtype=np.float64))
    L, W = BC.factor_blocks_blocked_emulation(K)
    Lr, Wr = BC.factor_blocks_reference(K)
    assert float((L - Lr).abs().max()) <= 1e-12 and float((W - Wr).abs().max()) <= 1e-12
    assert float(torch.triu(L, 1).abs().max()) == 0.0 and float(torch.triu(W, 1).abs().max()) == 0.0


def test_blocked_emulation_contract_cases():
    # NaN in a -I block and in one that fails only in its second 32-block,
    # finite values in the SPD block beside them, an identity exactly
    eye = torch.eye(T)
    late = eye.clone()
    late[40, 40] = -1.0
    spd = torch.from_numpy(_spd_blocks(1, seed=4))[0]
    L, W = BC.factor_blocks_blocked_emulation(torch.stack([eye, -eye, late, spd]))
    assert torch.equal(L[0], eye) and torch.equal(W[0], eye)
    assert torch.isnan(L[1]).any() and torch.isnan(W[1]).any()
    assert torch.isnan(L[2]).any() and torch.isnan(W[2]).any() and torch.equal(L[2, :32], eye[:32])
    assert torch.isfinite(L[3]).all() and torch.isfinite(W[3]).all()
    with pytest.raises(ValueError):
        BC.factor_blocks_blocked_emulation(torch.zeros(2, 128, 128))


def test_non_spd_block_gives_nan():
    # a non-positive pivot must give NaN in both outputs (no clamping);
    # the SPD block beside it stays finite
    K = torch.from_numpy(np.stack([np.eye(T, dtype=np.float32), -np.eye(T, dtype=np.float32)]))
    L, W = BC.factor_blocks(K)
    assert torch.isfinite(L[0]).all() and torch.isfinite(W[0]).all()
    assert torch.isnan(L[1]).any() and torch.isnan(W[1]).any()


def test_factor_blocks_rejects_bad_shapes_and_counts_no_cpu_launch():
    with pytest.raises(ValueError):
        BC.factor_blocks(torch.zeros(2, 32, 32))
    with pytest.raises(ValueError):
        BC.factor_blocks(torch.zeros(64, 64))
    before = BC.factor_blocks.launches
    BC.factor_blocks(torch.from_numpy(_spd_blocks(1, seed=1)))
    assert BC.factor_blocks.launches == before  # the counter counts kernel launches only


def test_chol_winv_batched_f64_matches_numpy():
    # f64 through the plain block version: exact to roundoff (N=192, 3 blocks)
    rng = np.random.default_rng(1)
    B, N = 3, 192
    A = rng.standard_normal((B, N, N)) / np.sqrt(N)
    K = A @ np.swapaxes(A, 1, 2) + np.eye(N)
    L, W = (a.numpy() for a in chol_winv_batched(torch.from_numpy(K)))
    np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=0, atol=1e-12)
    np.testing.assert_allclose(L @ W, np.broadcast_to(np.eye(N), (B, N, N)), rtol=0, atol=1e-12)
    assert np.all(np.triu(W, 1) == 0.0)
    # a width off the 64-block is identity-padded, and the pad sliced away
    L1, W1 = chol_winv_batched(torch.eye(100, dtype=torch.float64)[None])
    assert torch.equal(L1[0], torch.eye(100, dtype=torch.float64)) and torch.equal(W1, L1)


def test_library_arm_matches_the_block_and_panel_routes(monkeypatch):
    # a non-f32 CUDA Gram leaves the kernel routes for cholesky_ex and
    # triangular solves; here that arm is switched on for CPU f64 tensors,
    # so it runs without a card and is held against the routes' plain
    # versions: the same factors to roundoff
    from gpsat_tpu_torch.ops import linalg as LA

    rng = np.random.default_rng(2)
    A = rng.standard_normal((2, 256, 256)) / 16.0
    K = torch.from_numpy(A @ np.swapaxes(A, 1, 2) + np.eye(256))
    L0, W0 = LA.chol_winv_batched(K)
    P0, D0 = LA.chol_panels_batched(K)
    monkeypatch.setattr(LA, "_library_route", lambda K: K.dtype != torch.float32)
    L1, W1 = LA.chol_winv_batched(K)
    P1, D1 = LA.chol_panels_batched(K)
    for got, want in ((L1, L0), (W1, W0), (P1, P0), (D1, D0)):
        assert got.shape == want.shape and float((got - want).abs().max()) <= 1e-12
    # the library arm takes any width too
    L1, W1 = LA.chol_winv_batched(torch.eye(100, dtype=torch.float64)[None])
    assert torch.equal(L1[0], torch.eye(100, dtype=torch.float64)) and torch.equal(W1, L1)
