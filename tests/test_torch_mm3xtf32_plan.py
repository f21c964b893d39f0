"""The 3xTF32 kernel's launch plan (``gpsat_tpu_torch.ops.mm3xtf32.plan``),
on the CPU: the split over K chosen for the SGPR chunk loop's products and
for grids of few tiles, the load width of aligned and unaligned operands,
and the shared memory a block asks for. Imports no JAX."""

import itertools

import pytest
import torch

from gpsat_tpu_torch.ops import mm3xtf32 as MM

SMS = MM.H100_SMS


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _aligned(rows, cols):
    # (address, row stride, batch stride) of a contiguous [B, rows, cols] f32 tensor at a 256-byte boundary
    return (1 << 20, cols, rows * cols)


# the SGPR chunk loop's products at phase 9 (b)'s chunk (B = 8, M = 500,
# C = 4,096): W Kuf and dA = g A (NN), A A^T and dW = g Kuf^T (NT), dKuf =
# W^T g and dA = g^T A (TN); W the [8, 500, 500] view of an [8, 512, 512]
# buffer. (name, batch, M, N, K, a, b, splits, blocks)
CHUNK = [
    ("w_kuf", 8, 500, 4096, 500, (1 << 20, 512, 512 * 512), _aligned(500, 4096), 1, 1024),
    ("a_at", 8, 500, 500, 4096, _aligned(500, 4096), _aligned(500, 4096), 1, 128),
    ("d_w", 8, 500, 500, 4096, _aligned(500, 4096), _aligned(500, 4096), 1, 128),
    ("d_kuf", 8, 500, 4096, 500, (1 << 20, 512, 512 * 512), _aligned(500, 4096), 1, 1024),
    ("d_a_nn", 8, 500, 4096, 500, _aligned(500, 500), _aligned(500, 4096), 1, 1024),
]


@pytest.mark.parametrize("name,batch,M,N,K,a,b,splits,blocks", CHUNK, ids=[c[0] for c in CHUNK])
def test_the_chunk_products_keep_one_split_and_fill_the_card(name, batch, M, N, K, a, b, splits, blocks):
    # 1,024 tiles of 128 x 128 are 7.8 waves of one block per SM; A A^T's
    # 128 tiles at K = 4,096 are one wave of 128 on 132 SMs, which a split
    # over K would only cut into more waves of shorter blocks
    p = MM.plan(batch, M, N, K, a, b, SMS)
    assert (p.splits, p.blocks) == (splits, blocks)
    assert p.vec_a and p.vec_b
    assert p.blocks >= 0.95 * SMS


@pytest.mark.parametrize("batch,M,N,K,splits", [(2, 500, 500, 4096, 4), (1, 500, 500, 4096, 8),
                                                (2, 300, 260, 2048, 7), (1, 64, 64, 8192, 16),
                                                (1, 500, 500, 200, 1)])
def test_a_grid_of_few_tiles_is_split_over_k(batch, M, N, K, splits):
    # fewer tiles than SMs: K is cut until the blocks fill the card, each
    # split keeping at least MIN_SPLIT_STEPS K steps (K = 200 has 7 steps:
    # no split)
    p = MM.plan(batch, M, N, K, _aligned(M, K), _aligned(K, N), SMS)
    tiles = batch * -(-M // MM.BM) * -(-N // MM.BN)
    assert p.splits == splits and p.blocks == tiles * splits
    assert p.blocks <= SMS or splits == 1


@pytest.mark.parametrize("ptr,ld,stride,batch,vec", [
    (1 << 20, 512, 512 * 512, 8, True),   # the pair's W view
    ((1 << 20) + 4, 512, 512 * 512, 8, False),  # x[:, :, 1:] of a contiguous x: base 4 bytes off
    (1 << 20, 45, 45 * 70, 2, False),     # a row stride of 180 bytes
    (1 << 20, 48, 48 * 70 + 1, 2, False),  # a batch stride off a 16-byte multiple
    (1 << 20, 48, 48 * 70 + 1, 1, True),  # one batch: its stride is never used
])
def test_the_load_width_follows_the_operand_alignment(ptr, ld, stride, batch, vec):
    p = MM.plan(batch, 70, 96, 48, (ptr, ld, stride), _aligned(48, 96), SMS)
    assert p.vec_a is vec and p.vec_b
    assert MM.vec16(ptr, ld, stride, batch) is vec


def test_no_plan_asks_for_more_shared_memory_than_a_block_has():
    # 227 KB a block on an H100; the plan never asks for more splits than K
    # has steps, nor for a split of fewer than MIN_SPLIT_STEPS steps
    assert MM.SMEM_BYTES == (MM.STAGES * 2 + MM.SPLITS * 2) * MM.BM * MM.BK * 4 + 1024 <= MM.SMEM_LIMIT == 232_448
    for batch, M, N, K, sms in itertools.product((1, 3, 8, 64), (1, 70, 500, 4096), (1, 129, 500, 4096),
                                                 (0, 9, 300, 500, 4096, 65536), (1, 66, 132)):
        p = MM.plan(batch, M, N, K, _aligned(M, max(K, 1)), _aligned(max(K, 1), N), sms)
        steps = -(-K // MM.BK)
        assert p.smem_bytes == MM.SMEM_BYTES <= MM.SMEM_LIMIT
        assert 1 <= p.splits <= MM.MAX_SPLITS
        assert p.splits == 1 or steps // p.splits >= MM.MIN_SPLIT_STEPS
