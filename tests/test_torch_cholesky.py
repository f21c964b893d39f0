"""The port's blocked Cholesky (gpsat_tpu_torch/ops/cholesky.py), its
backward, the recursive factor pair and the rest of ops/linalg.py's factor
helpers against the Pallas kernel and the JAX functions they replace.

On the CPU, ``cholesky`` runs its plain PyTorch version inside the kernel's
domain (f32, N a multiple of 128 up to 1024) and ``torch.linalg.cholesky_ex``
elsewhere; the CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import gpsat_tpu.ops.pallas.cholesky as jpc
from gpsat_tpu.ops import linalg as JLA
from gpsat_tpu.ops.recursive_chol import chol_winv_recursive as jax_chol_winv_recursive
from gpsat_tpu_torch.ops import cholesky as CH
from gpsat_tpu_torch.ops import linalg as LA
from gpsat_tpu_torch.ops.recursive_chol import chol_winv_recursive


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(B, N, seed, dtype=np.float64, rank=16):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, rank)).astype(dtype)
    return A @ np.transpose(A, (0, 2, 1)) + np.eye(N, dtype=dtype)[None]


@pytest.mark.parametrize("N", [128, 256])
def test_reference_matches_pallas_kernel(N):
    # same f32 inputs through the Pallas kernel (interpret mode) and the
    # port's plain version of the CUDA kernel: relative 5e-6 of the largest
    # entry, the bound the JAX package's own test holds its kernel to
    K = _spd(2, N, seed=0, dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        Lp = np.asarray(jpc._pallas_chol_batched(jnp.asarray(K)))
    before = CH.cholesky.launches
    L = CH.cholesky(torch.from_numpy(K)).numpy()
    assert CH.cholesky.launches == before  # the counter counts kernel launches only
    assert np.abs(L - Lp).max() / np.abs(Lp).max() < 5e-6
    Lref = np.linalg.cholesky(K.astype(np.float64))
    assert np.abs(L - Lref).max() / np.abs(Lref).max() < 5e-6
    assert np.all(np.triu(L, 1) == 0.0)
    # an unbatched matrix takes the same arm
    np.testing.assert_array_equal(CH.cholesky(torch.from_numpy(K[0])).numpy(), L[0])
    # the CUDA kernel's blocked order (32-wide panels inside each 128-block,
    # the panel by blocks of the inverse) on the same input: another f32
    # summation order, held to the same bound against both
    Le = CH.cholesky_blocked_emulation(torch.from_numpy(K)).numpy()
    assert np.abs(Le - Lp).max() / np.abs(Lp).max() < 5e-6
    assert np.abs(Le - Lref).max() / np.abs(Lref).max() < 5e-6
    assert np.all(np.triu(Le, 1) == 0.0)


def _spd_card(B, N, seed, dtype):
    # chip_smoke.py's kernel-3 input: A A^T + N I, A standard normal, so K's
    # entries reach ~2N and L's ~sqrt(2N)
    A = np.random.default_rng(seed).standard_normal((B, N, N)).astype(dtype)
    return A @ np.swapaxes(A, 1, 2) + N * np.eye(N, dtype=dtype)


def test_blocked_emulation_f64_matches_reference():
    # B=2, N=256 in f64: the same algebra in another order; L's entries are
    # up to ~20, so 1e-10 absolute is f64 roundoff with room
    K = torch.from_numpy(_spd_card(2, 256, seed=10, dtype=np.float64))
    np.testing.assert_allclose(
        CH.cholesky_blocked_emulation(K).numpy(), CH.cholesky_reference(K).numpy(), rtol=0, atol=1e-10
    )


@pytest.mark.parametrize("seed", [11, 12])
def test_blocked_emulation_f32_within_the_kernel_bounds(seed):
    # the bounds the card holds the kernel to (chip_smoke.py phase 2): 2e-4
    # absolute against the plain version, max |L L^T - K| <= 1e-5 N
    N = 256
    K = torch.from_numpy(_spd_card(2, N, seed, np.float32))
    L = CH.cholesky_blocked_emulation(K)
    assert float((L - CH.cholesky_reference(K)).abs().max()) <= 2e-4
    assert float((torch.matmul(L, L.transpose(1, 2)) - K).abs().max()) <= 1e-5 * N
    assert float(torch.triu(L, 1).abs().max()) == 0.0


def test_blocked_emulation_keeps_nan_isolation_and_exact_identity():
    # the rsqrt pivot with no clamp: -I gives NaN, and so does a matrix that
    # fails only in its second 128-block (its first 128 rows stay exact); the
    # identity beside them comes back exactly
    N = 256
    eye = torch.eye(N)
    late = eye.clone()
    late[200, 200] = -1.0
    L = CH.cholesky_blocked_emulation(torch.stack([eye, -eye, late]))
    assert torch.equal(L[0], eye)
    assert torch.isnan(L[1]).any() and torch.isnan(L[2]).any()
    assert torch.equal(L[2, :128], eye[:128])
    with pytest.raises(ValueError):
        CH.cholesky_blocked_emulation(torch.zeros(1, 192, 192))


def test_non_spd_matrix_gives_nan_on_both_arms():
    # a failed factorisation gives NaN in that matrix only and never raises
    # for the batch: inside the kernel's domain (f32, N=128: the plain
    # version's rsqrt) and outside it (f64 and N=100: cholesky_ex + NaN fill)
    for N, dtype in ((128, torch.float32), (128, torch.float64), (100, torch.float32)):
        eye = torch.eye(N, dtype=dtype)
        L = CH.cholesky(torch.stack([eye, -eye]))
        assert torch.equal(L[0], eye), (N, dtype)
        assert torch.isnan(L[1]).any(), (N, dtype)
        _, ok = LA.safe_cholesky(torch.stack([eye, -eye]))
        assert ok.tolist() == [True, False], (N, dtype)
    assert CH.in_kernel_domain(torch.zeros(1, 1024, 1024)) and not CH.in_kernel_domain(torch.zeros(1, 1152, 1152))
    with pytest.raises(ValueError):
        CH.cholesky(torch.zeros(2, 3, 4))


def test_backward_matches_jax_pullback_and_gradcheck():
    # the Function's backward against the JAX package's _chol_bwd on the same
    # (L, dL) in f64: the same two triangular solves, 1e-10 of the largest
    # entry; then gradcheck through a symmetrised input (the factor reads
    # only the lower triangle, its pullback is the symmetric one)
    rng = np.random.default_rng(1)
    K = _spd(2, 12, seed=2)
    dL = rng.standard_normal(K.shape)
    Kt = torch.from_numpy(K).requires_grad_(True)
    L = CH.cholesky(Kt)
    (dK,) = torch.autograd.grad(L, Kt, torch.from_numpy(dL))
    (dKj,) = jpc._chol_bwd(jnp.asarray(L.detach().numpy()), jnp.asarray(dL))
    np.testing.assert_allclose(dK.numpy(), np.asarray(dKj), rtol=0, atol=1e-10 * np.abs(dKj).max())

    A = torch.from_numpy(_spd(1, 6, seed=3, rank=6)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a: CH.cholesky(0.5 * (a + a.transpose(-1, -2))), (A,))


def test_chol_winv_pullback_matches_jax_vjp():
    # (L, W) cotangents pulled back to K in f64, against jax.vjp of the JAX
    # package's chol_winv on each matrix: the same matmul formula, 1e-9
    rng = np.random.default_rng(4)
    B, N = 2, 64
    K = _spd(B, N, seed=5, rank=N)
    dL, dW = rng.standard_normal((2, B, N, N))

    def jax_pullback(Kb, dLb, dWb):
        _, vjp = jax.vjp(JLA.chol_winv, Kb)
        return vjp((dLb, dWb))[0]

    want = np.stack([np.asarray(jax_pullback(*(jnp.asarray(a[b]) for a in (K, dL, dW)))) for b in range(B)])
    for factor in LA.PAIR_ROUTES:
        Kt = torch.from_numpy(K).requires_grad_(True)
        L, W = LA.chol_winv(Kt, factor)
        (dK,) = torch.autograd.grad([L, W], Kt, [torch.from_numpy(dL), torch.from_numpy(dW)])
        np.testing.assert_allclose(dK.numpy(), want, rtol=0, atol=1e-9 * np.abs(want).max(), err_msg=factor)
    with pytest.raises(ValueError):
        LA.chol_winv_pair(torch.from_numpy(K), "panel")


def test_factor_pairs_match_jax_functions_f64():
    # recursive pair (default and a smaller blocking, a ragged N), blocked
    # triangular inverse incl. the N=100 identity padding, the padded pair
    # and the solve helpers, in f64 against the JAX functions: 1e-10
    K = _spd(2, 160, seed=6, rank=160)
    Kt = torch.from_numpy(K)
    Lj, Wj = jax_chol_winv_recursive(jnp.asarray(K), base=64, micro=32)
    for kw in ({}, {"base": 32, "micro": 8}, {"base": 16, "micro": 3}):
        L, W = chol_winv_recursive(Kt, **kw)
        np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=0, atol=1e-10)
        assert np.all(np.triu(L.numpy(), 1) == 0.0) and np.all(np.triu(W.numpy(), 1) == 0.0)

    for N in (100, 192, 48):
        Lc = np.linalg.cholesky(_spd(2, N, seed=7, rank=N))
        want = np.stack([np.asarray(JLA.tri_inv_blocked(jnp.asarray(Lc[b]))) for b in range(2)])
        np.testing.assert_allclose(LA.tri_inv_blocked(torch.from_numpy(Lc)).numpy(), want, rtol=0, atol=1e-10)

    K100 = _spd(2, 100, seed=8, rank=100)
    # one matrix at a time: under vmap the JAX pair routes to a Pallas kernel
    Lj, Wj = (jnp.stack(a) for a in zip(*(JLA.chol_winv_padded(jnp.asarray(K100[b])) for b in range(2))))
    for factor in LA.PAIR_ROUTES:
        L, W = LA.chol_winv_padded(torch.from_numpy(K100), factor=factor)
        np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=0, atol=1e-10, err_msg=factor)
        np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=0, atol=1e-10, err_msg=factor)

    rhs = np.random.default_rng(9).standard_normal((2, 100, 3))
    Lt = torch.from_numpy(np.array(Lj))
    want = np.stack([np.asarray(JLA.cho_solve(Lj[b], jnp.asarray(rhs[b]))) for b in range(2)])
    np.testing.assert_allclose(LA.cho_solve(Lt, torch.from_numpy(rhs)).numpy(), want, rtol=0, atol=1e-10)
    want = np.stack([np.asarray(JLA.logdet_from_chol(Lj[b])) for b in range(2)])
    np.testing.assert_allclose(LA.logdet_from_chol(Lt).numpy(), want, rtol=1e-12)
    Lc, Wc = LA.chol_inv(torch.from_numpy(K100))
    np.testing.assert_allclose(Wc.numpy(), np.asarray(Wj), rtol=0, atol=1e-10)
