"""Batched f32 matrix product by the 3xTF32 split, C = op(A) op(B).

The counterpart of XLA's ``Precision.HIGH`` dot, which the JAX package gives
its relaxed accumulation products (``gpsat_tpu/ops/precision.py``); it
replaces no Pallas kernel. Each f32 operand x is split into hi = tf32(x)
and lo = tf32(x - hi) (tf32 rounding as ``cvt.rna.tf32.f32``: to nearest,
ties away from zero, 10 mantissa bits), and the product is lo hi + hi lo +
hi hi in f32: about 3 * 2^-22 of |a||b| per product, against 2^-11 for
plain TF32. ``mm3xtf32(a, b, transpose_a=, transpose_b=)`` on [B, ., .]
f32 tensors:

- a CUDA tensor goes through the hand-written kernel ``csrc/mm3xtf32.cu``
  (Hopper: cp.async staging, one split per staged tile, wgmma tf32), as
  ``plan`` sets it up for the call, or the call raises;
- a CPU tensor goes through ``mm3xtf32_reference``: the same split and three
  true-f32 products summed.

``MM3xTF32.apply`` makes it differentiable; its backward runs the same
product (JAX's dot transpose keeps the dot's precision). The kernel decides
its precision itself: nothing here touches PyTorch's process-wide TF32
switch, which the package keeps off. The library is built and loaded by
``ops/_build.py`` at first use. Each launch adds one to
``mm3xtf32.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from gpsat_tpu_torch.ops import _build

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SYMBOLS = {
    "gpsat_mm3xtf32_f32": [_VP, _LL, _LL, _INT, _VP, _LL, _LL, _INT, _VP, _INT, _INT, _INT, _INT, _VP],
    "gpsat_mm3xtf32_plan_f32": [_VP, _LL, _LL, _INT, _INT, _VP, _LL, _LL, _INT, _INT, _VP, _VP, _INT, _INT, _INT,
                                _INT, _INT, _VP],
}

# csrc/mm3xtf32.cu's block tile of C, K step and rings of raw stages and of
# split B tiles; a block asks for the raw ring (A and B), the split ring (hi
# and lo) and 1 KB of alignment
BM = BN = 128
BK = 32
STAGES, SPLITS = 4, 3
SMEM_BYTES = (STAGES * 2 + SPLITS * 2) * BM * BK * 4 + 1024
SMEM_LIMIT = 232_448  # a block's shared memory on an H100 (227 KB)
H100_SMS = 132
MIN_SPLIT_STEPS = 8  # a split of K keeps at least 8 K steps (256 of K)
MAX_SPLITS = 16


@dataclass(frozen=True)
class Plan:
    """How one call of the kernel is laid out: ``splits`` blocks a tile of
    C over K (their partials added in split order), 16-byte copies of each
    operand or not, the grid's blocks and each block's shared memory."""

    splits: int
    vec_a: bool
    vec_b: bool
    blocks: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vec16(ptr: int, ld: int, stride: int, batch: int) -> bool:
    """Whether an f32 operand takes 16-byte copies: its base address, row
    stride and (with more than one batch) batch stride in 16-byte
    multiples."""
    return ptr % 16 == 0 and ld % 4 == 0 and (batch == 1 or stride % 4 == 0)


def plan(batch: int, M: int, N: int, K: int, a: Tuple[int, int, int], b: Tuple[int, int, int],
         sms: int = H100_SMS) -> Plan:
    """The kernel's plan for op(A) op(B) of [batch, M, K] x [batch, K, N]
    on a card of ``sms`` SMs; ``a``, ``b``: each operand's (address, row
    stride, batch stride), strides in elements.

    A block takes SMEM_BYTES, so one runs per SM and the grid runs in waves
    of ``sms`` blocks. The split over K is the one of at most MAX_SPLITS,
    each of at least MIN_SPLIT_STEPS K steps, whose waves times K steps a
    block is least (the fewest splits among equals): a grid that fills the
    card keeps one split, one of few tiles is cut over K until it fills
    it."""
    tiles = batch * _cdiv(M, BM) * _cdiv(N, BN)
    splits = _splits(tiles, _cdiv(K, BK), sms)
    return Plan(splits=splits, vec_a=vec16(*a, batch), vec_b=vec16(*b, batch), blocks=tiles * splits,
                smem_bytes=SMEM_BYTES)


@functools.lru_cache(maxsize=1024)
def _splits(tiles: int, steps: int, sms: int) -> int:
    best, splits = None, 1
    for s in range(1, max(1, min(MAX_SPLITS, steps // MIN_SPLIT_STEPS)) + 1):
        cost = _cdiv(tiles * s, sms) * _cdiv(steps, s)
        if best is None or cost < best:
            best, splits = cost, s
    return splits


_sms = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> f32 rounded to TF32 (``cvt.rna.tf32.f32``: to nearest, ties
    away from zero, the low 13 mantissa bits zero), done on the bits as the
    kernel does; infinities and NaN pass through."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    bits = (x.view(torch.int32) + 0x1000) & -0x2000  # -0x2000 is 0xffffe000 as int32
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def _op(x: torch.Tensor, transpose: bool) -> torch.Tensor:
    return x.transpose(-1, -2) if transpose else x


def mm3xtf32_reference(a: torch.Tensor, b: torch.Tensor, transpose_a: bool = False,
                       transpose_b: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same split of each f32
    operand and the three true-f32 products lo hi + hi lo + hi hi."""
    a, b = _op(a, transpose_a), _op(b, transpose_b)
    a_hi, b_hi = round_tf32(a), round_tf32(b)
    a_lo, b_lo = round_tf32(a - a_hi), round_tf32(b - b_hi)
    return torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_hi, b_hi)


def _unit_rows(x: torch.Tensor) -> bool:
    """Whether a [B, R, C] tensor's rows are unit-stride and do not overlap."""
    return (x.stride(2) == 1 or x.shape[2] <= 1) and (x.stride(1) >= x.shape[2] or x.shape[1] <= 1)


def _operand(name: str, x: torch.Tensor, transpose: bool, batch: int):
    """(rows, cols of op(x), leading dimension, batch stride) of a [B, ., .]
    operand the kernel takes: unit-stride rows (``_unit_rows``), batch B."""
    if not _unit_rows(x):
        raise ValueError(f"mm3xtf32: {name} must have unit-stride rows, got strides {x.stride()}")
    if x.shape[0] != batch:
        raise ValueError(f"mm3xtf32: {name} has batch {x.shape[0]}, expected {batch}")
    rows, cols = (x.shape[2], x.shape[1]) if transpose else (x.shape[1], x.shape[2])
    return rows, cols, max(x.stride(1), x.shape[2], 1), x.stride(0)


def mm3xtf32(a: torch.Tensor, b: torch.Tensor, transpose_a: bool = False, transpose_b: bool = False) -> torch.Tensor:
    """op(a) op(b) [B, M, N] of [B, ., .] f32 tensors by the 3xTF32 split
    (op = transpose where asked).

    CUDA tensors launch the hand-written kernel as ``plan`` lays it out
    (f32, each operand's rows unit-stride, any row and batch stride: a
    sliced W needs no copy) and raise on anything it does not take; CPU
    tensors run the plain version."""
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"mm3xtf32 takes two [B, ., .] tensors, got {tuple(a.shape)} and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"mm3xtf32: a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return mm3xtf32_reference(a, b, transpose_a, transpose_b)
    if a.device.type != "cuda":
        raise ValueError(f"mm3xtf32: unsupported device {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 only, got {a.dtype} and {b.dtype}")
    batch = a.shape[0]
    M, K, lda, sa = _operand("a", a, transpose_a, batch)
    Kb, N, ldb, sb = _operand("b", b, transpose_b, batch)
    if Kb != K:
        raise ValueError(f"mm3xtf32: inner dimensions differ, {K} and {Kb}")
    C = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    if C.numel() == 0:
        return C
    p = plan(batch, M, N, K, (a.data_ptr(), lda, sa), (b.data_ptr(), ldb, sb), _sm_count(a.device))
    # the splits' partial sums, added in split order into C
    work = torch.empty(p.splits * C.numel(), dtype=torch.float32, device=a.device) if p.splits > 1 else None
    lib = _build.load_library("mm3xtf32", _SYMBOLS)
    _build.launch("mm3xtf32", lib.gpsat_mm3xtf32_plan_f32, a, a.data_ptr(), lda, sa, int(transpose_a),
                  int(p.vec_a), b.data_ptr(), ldb, sb, int(transpose_b), int(p.vec_b), C.data_ptr(),
                  None if work is None else work.data_ptr(), batch, M, N, K, p.splits)
    _build.count_launch(mm3xtf32)
    return C


mm3xtf32.launches = 0


def _rows_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if _unit_rows(x) else x.contiguous()


class MM3xTF32(torch.autograd.Function):
    """Differentiable ``mm3xtf32``: dA and dB are 3xTF32 products of the
    output's gradient with the other operand, in whichever orientation
    gives op(A)'s and op(B)'s own layout back."""

    @staticmethod
    def forward(ctx, a, b, transpose_a: bool = False, transpose_b: bool = False):
        a, b = _rows_contiguous(a), _rows_contiguous(b)
        ctx.save_for_backward(a, b)
        ctx.transpose_a, ctx.transpose_b = transpose_a, transpose_b
        return mm3xtf32(a, b, transpose_a, transpose_b)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ta, tb = ctx.transpose_a, ctx.transpose_b
        g = _rows_contiguous(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            # d op(A) = g op(B)^T; with op(A) = A^T, dA = op(B) g^T
            ga = mm3xtf32(b, g, tb, True) if ta else mm3xtf32(g, b, False, not tb)
        if ctx.needs_input_grad[1]:
            # d op(B) = op(A)^T g; with op(B) = B^T, dB = g^T op(A)
            gb = mm3xtf32(g, a, True, ta) if tb else mm3xtf32(a, g, not ta, False)
        return ga, gb, None, None
