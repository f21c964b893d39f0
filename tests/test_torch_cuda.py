"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions. Every test is marked ``cuda`` and skips without a CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gpsat_tpu_torch.ops import block_chol as BC
from gpsat_tpu_torch.ops.linalg import chol_winv_batched

T = 64


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spd(B, N, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, N, N)) / np.sqrt(N)
    return (A @ np.swapaxes(A, 1, 2) + np.eye(N)).astype(np.float32)


@pytest.mark.cuda
def test_block_kernel_matches_reference():
    dev = _cuda()
    K = torch.from_numpy(_spd(512, T, seed=0)).to(dev)
    before = BC.factor_blocks.launches
    L, W = BC.factor_blocks(K)
    torch.cuda.synchronize()
    assert BC.factor_blocks.launches == before + 1
    Lr, Wr = BC.factor_blocks_reference(K)
    # f32 on the card, FMA-contracted in the kernel and not in the plain
    # version: 1e-4 absolute on O(1) entries
    assert float((L - Lr).abs().max()) <= 1e-4
    assert float((W - Wr).abs().max()) <= 1e-4
    eye = torch.eye(T, device=dev)
    assert float((torch.matmul(L, W) - eye).abs().max()) <= 1e-4
    assert float(torch.triu(L, 1).abs().max()) == 0.0 and float(torch.triu(W, 1).abs().max()) == 0.0


@pytest.mark.cuda
def test_block_kernel_nan_and_refusals():
    dev = _cuda()
    eye = torch.eye(T, device=dev)
    L, W = BC.factor_blocks(torch.stack([eye, -eye]).contiguous())
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1]).any() and torch.isnan(W[1]).any()
    with pytest.raises(TypeError):
        BC.factor_blocks(eye[None].double())
    with pytest.raises(ValueError):
        BC.factor_blocks(torch.eye(2 * T, device=dev).reshape(4, T, T).transpose(1, 2))


@pytest.mark.cuda
def test_driver_on_card_matches_cpu_f64():
    # the whole factor pair, f32 through the kernel vs f64 through the plain
    # version; cond(K) <= ~5 here, so f32 agrees to ~1e-5
    dev = _cuda()
    K = _spd(8, 256, seed=1)
    L, W = chol_winv_batched(torch.from_numpy(K).to(dev))
    L64, W64 = chol_winv_batched(torch.from_numpy(K).double())
    assert float((L.double().cpu() - L64).abs().max()) <= 1e-4
    assert float((W.double().cpu() - W64).abs().max()) <= 1e-4
