"""Padded shape buckets of expert tiles (numpy, host side).

The port's own copy of the parts of ``gpsat_tpu/parallel/batching.py`` the
engine needs: ``TileBatch``, ``round_up``, ``bucket_size``, ``take_batch``,
``cast_batch`` and ``pad_batch_to``. Experts are grouped into buckets padded
to a shared Nmax, with a row-validity mask; masked rows are neutralised in
the Gram matrix (ops/linalg.mask_gram).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

LANE = 128


def round_up(n: int, multiple: int = LANE) -> int:
    return int(-(-n // multiple) * multiple)


def bucket_size(n: int, multiple: int = LANE) -> int:
    """Pad target for a tile of n rows: next power-of-two multiple of
    ``multiple`` (fewer distinct shapes)."""
    m = round_up(max(n, 1), multiple)
    p = multiple
    while p < m:
        p *= 2
    return p


@dataclasses.dataclass
class TileBatch:
    """One shape bucket of padded expert tiles."""

    X: np.ndarray  # [B, Nmax, D]  scaled training coords
    y: np.ndarray  # [B, Nmax]     scaled, de-meaned obs
    mask: np.ndarray  # [B, Nmax]  1.0 valid / 0.0 padded
    Xnew: np.ndarray  # [B, Pmax, D] scaled prediction coords
    pred_mask: np.ndarray  # [B, Pmax]
    obs_mean: np.ndarray  # [B] per-tile subtracted mean (0 unless obs_mean='local')
    expert_index: np.ndarray  # [B] row index into the expert-locations table
    num_obs: np.ndarray  # [B] true (unpadded) obs count
    expert_loc: Optional[np.ndarray] = None  # [B, D] scaled expert locations

    @property
    def B(self) -> int:
        return self.X.shape[0]

    @property
    def Nmax(self) -> int:
        return self.X.shape[1]

    @property
    def Pmax(self) -> int:
        return self.Xnew.shape[1]


def take_batch(batch: TileBatch, idx: np.ndarray) -> TileBatch:
    """Row-subset of a batch (idx indexes the expert axis)."""
    idx = np.asarray(idx)
    rep = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        rep[f.name] = None if v is None else np.asarray(v)[idx]
    return TileBatch(**rep)


def cast_batch(batch: TileBatch, dtype) -> TileBatch:
    """Same tiles at a different float dtype (integer fields untouched)."""
    rep = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is not None and np.issubdtype(np.asarray(v).dtype, np.floating):
            v = np.asarray(v).astype(dtype)
        rep[f.name] = v
    return TileBatch(**rep)


def pad_batch_to(batch: TileBatch, B_target: int) -> TileBatch:
    """Pad the expert axis with dead tiles (mask all-zero, expert_index -1)."""
    B = batch.B
    if B == B_target:
        return batch
    if B_target < B:
        raise ValueError(f"cannot pad a batch of {B} down to {B_target}")
    pad = B_target - B

    def padB(a, fill=0.0):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)], axis=0)

    return TileBatch(
        X=padB(batch.X),
        y=padB(batch.y),
        mask=padB(batch.mask),
        Xnew=padB(batch.Xnew),
        pred_mask=padB(batch.pred_mask),
        obs_mean=padB(batch.obs_mean),
        expert_index=padB(batch.expert_index, fill=-1),
        num_obs=padB(batch.num_obs, fill=0),
        expert_loc=None if batch.expert_loc is None else padB(batch.expert_loc),
    )
