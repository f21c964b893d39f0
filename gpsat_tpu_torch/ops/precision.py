"""Matmul precision of the conditioning-safe accumulation products.

The port's copy of ``gpsat_tpu/ops/precision.py``. The JAX package reads a
level from an environment variable at trace time and gives it to the chunked
SGPR accumulation products ``A_i = W Kuf_i``, ``A_i A_i^T`` and ``A_i ym_i``
(2 M^2 C flops each: nearly all of a large-N bound). Their target
``B = A A^T + I`` has eigenvalues >= 1, so an error of ~1e-7 of |A||A| in
A A^T cannot break B's factor. Every other product (the Gram's cross
product, the triangular pairs) stays true f32: those are the
conditioning-critical ones.

Here the level is an argument, never an environment variable: the SGPR core
(``models/sgpr.make_sgpr_core(accum_precision=...)``), the SVGP collapsed
bound and ``collapsed_q`` that reuse its terms, and the orchestrator, which
reads it from the model's ``init_params`` as it reads ``chunk_size``.

- ``"highest"`` (the default): ``torch.matmul``, true f32 (the package keeps
  TF32 off).
- ``"high"``: an f32 product by the 3xTF32 split (``ops/mm3xtf32``, the
  hand-written kernel on the card), the counterpart of the TPU's 3-pass
  bf16 ``Precision.HIGH``: f32-like error at tensor-core rate. Plain
  single-pass TF32 (PyTorch's own "high") is never used: it keeps ~3
  decimal digits and is a process-wide switch, which would reach every
  other product of every thread. A product in another dtype than f32 (the
  f64 polish) has no split and stays a true product at either level.
"""

from __future__ import annotations

import torch

from gpsat_tpu_torch.ops.mm3xtf32 import MM3xTF32

LEVELS = ("high", "highest")


def accum_precision(level: str = "highest") -> str:
    """The validated level of the conditioning-safe accumulation products
    (``"high"`` or ``"highest"``, any case). NOT for Gram cross products or
    triangular-inverse updates: those take true f32 (module docstring)."""
    name = str(level).lower()
    if name not in LEVELS:
        raise ValueError(f"accum_precision={level!r}: expected one of {list(LEVELS)}")
    return name


def accum_matmul(a: torch.Tensor, b: torch.Tensor, level: str = "highest", *, transpose_b: bool = False) -> torch.Tensor:
    """a op(b) of [B, ., .] tensors at ``level`` (op(b) = b^T with
    ``transpose_b``): ``torch.matmul`` at "highest" (bit for bit the product
    without this function), the differentiable 3xTF32 product at "high" for
    f32 operands."""
    if accum_precision(level) == "high" and a.dtype == torch.float32 and b.dtype == torch.float32:
        return MM3xTF32.apply(a, b, False, transpose_b)
    return torch.matmul(a, b.transpose(1, 2) if transpose_b else b)
