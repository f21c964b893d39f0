"""Legacy import path (ref: GPSat/vff.py — the VFF spectral engine, adapted
there from github.com/st--/VFF); the port's own copy of ``gpsat_tpu/vff.py``.

The implementation lives in models/vff.py and materialises the spectral
Kuu matrices densely, batched over experts (a leading B axis); the
reference's structured-matrix classes (DiagMat, Rank1Mat, LowRankMat,
BlockDiagMat, vff.py:14-377) have no analogue, by design. The names below
take one expert's unbatched values, as the reference's do, and return torch
tensors (float64 unless given tensors of another dtype):

  make_Kuu(kernel, lengthscale, variance, a, b, M) -> dense [2M-1, 2M-1]
  make_Kuf(kernel, lengthscale, X1d, a, b, M)      -> [2M-1, N]
  kron / kron_two                                   -> dense Kronecker
  make_kvs / make_kvs_two                           -> ROW-wise Khatri-Rao
                                                       (the tf convention)
  make_kvs_np / make_kvs_two_np                     -> COLUMN-wise twins
                                                       (the np convention)
  GPR_kron                                          -> VFFModel (collapsed
                                                       ELBO + posterior)

``elbo``, ``predict``, ``product_prior_gram`` and ``vff_common`` are the
batched functions of models/vff.py.
"""

from functools import reduce

import torch

from gpsat_tpu_torch.models.vff import (  # noqa: F401
    VFFModel,
    VFFModel as GPR_kron,
    elbo,
    make_kuf as _make_kuf_batched,
    make_kuu_dense as _make_kuu_batched,
    make_kvs as _make_kvs_cols_batched,
    predict,
    product_prior_gram,
    vff_common,
)


def _t(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    dtype = like.dtype if isinstance(like, torch.Tensor) else torch.float64
    return torch.as_tensor(x, dtype=dtype)


def _one(x, like=None) -> torch.Tensor:
    """A scalar as a [1] tensor (a batch of one expert)."""
    return _t(x, like).reshape(1)


def make_Kuu(kernel: str, lengthscale, variance, a, b, M: int) -> torch.Tensor:
    """Dense Kuu [2M-1, 2M-1] of one dimension; cos block then sin block."""
    ls = _one(lengthscale)
    return _make_kuu_batched(kernel, ls, _one(variance, ls), _one(a, ls), _one(b, ls), M)[0]


def make_Kuf(kernel: str, lengthscale, X1d, a, b, M: int) -> torch.Tensor:
    """Kuf [2M-1, N] of one dimension with the edge corrections outside
    [a, b] (vff.py:457-523); X1d: [N] scaled coordinates."""
    ls = _one(lengthscale, X1d)
    return _make_kuf_batched(kernel, ls, _t(X1d, ls).reshape(1, -1), _one(a, ls), _one(b, ls), M)[0]


make_Kuf_np = make_Kuf


def kron(mats) -> torch.Tensor:
    """Kronecker product of a list of matrices (``models.vff.kron`` is the
    batched one, of square matrices)."""
    return reduce(torch.kron, [_t(m) for m in mats])


def kron_two(A, B):
    """Kronecker product of two matrices (ref: vff.py:528-534)."""
    return kron([A, B])


def make_kvs_two(A, B):
    """ROW-wise Khatri-Rao ('Kronecker-vector stack'), the reference's tf
    convention (ref: vff.py:540-546): [N, Ma] x [N, Mb] -> [N, Ma*Mb]."""
    A, B = _t(A), _t(B)
    return (A[:, :, None] * B[:, None, :]).reshape(A.shape[0], A.shape[1] * B.shape[1])


def make_kvs(k):
    """Row-wise Khatri-Rao of a list of matrices (ref: vff.py:548-550)."""
    return reduce(make_kvs_two, k)


def make_kvs_two_np(A, B):
    """COLUMN-wise Khatri-Rao, the reference's numpy twin (ref:
    vff.py:553-556): [Ma, N] x [Mb, N] -> [Ma*Mb, N]."""
    return make_kvs_np([A, B])


def make_kvs_np(A_list):
    """Column-wise Khatri-Rao of a list of matrices (ref: vff.py:558-559)."""
    return _make_kvs_cols_batched([_t(a)[None] for a in A_list])[0]


__all__ = [
    "GPR_kron",
    "VFFModel",
    "elbo",
    "kron",
    "kron_two",
    "make_Kuf",
    "make_Kuf_np",
    "make_Kuu",
    "make_kvs",
    "make_kvs_np",
    "make_kvs_two",
    "make_kvs_two_np",
    "predict",
    "product_prior_gram",
    "vff_common",
]
