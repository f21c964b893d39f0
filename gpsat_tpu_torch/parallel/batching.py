"""Padded shape buckets of expert tiles (numpy, host side).

The port's own copy of ``gpsat_tpu/parallel/batching.py``: ``TileBatch``,
``assemble_tiles``, ``auto_batch_cap``, ``round_up``, ``bucket_size``,
``take_batch``, ``cast_batch`` and ``pad_batch_to``. Every expert's index set
is computed up front on the host; experts are then grouped into shape
buckets padded to a shared Nmax, with a row-validity mask, and each bucket
runs as one batched program. Masked rows are neutralised in the Gram matrix
(ops/linalg.mask_gram).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

LANE = 128

# The exact-GPR fused value+grad keeps ~LIVE_FACTOR [B, Nmax, Nmax] buffers
# live at once (K, L, W and their adjoints): the port's main path peaked at
# 4.368 GB for B=512, N=512 in f32, 8.1 such buffers (PERF.md, section 6)
_LIVE_FACTOR = 8
_F32_BYTES = 4


def auto_batch_cap(nmax: int, device=None, free_share: float = 0.5) -> Optional[int]:
    """Most experts per [B, nmax, nmax] f32 program that fit the device's
    memory budget, or None (no cap) for a CPU device.

    On a CUDA device the budget is ``free_share`` (default 0.5) of the free
    bytes that ``torch.cuda.mem_get_info`` reports, spent on _LIVE_FACTOR
    live [nmax, nmax] f32 buffers per expert.
    """
    import torch

    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    cap = int(free_share * free / (_LIVE_FACTOR * nmax * nmax * _F32_BYTES))
    return max(cap, 1)


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


def assemble_tiles(
    coords: np.ndarray,
    obs: np.ndarray,
    tile_indices: Sequence[np.ndarray],
    pred_coords: Sequence[np.ndarray],
    expert_index: Optional[np.ndarray] = None,
    *,
    expert_locs: Optional[np.ndarray] = None,
    coords_scale=None,
    obs_mean: Optional[str] = None,
    max_batch_size: Optional[int] = None,
    memory_cap: bool = False,
    cap_width: Optional[int] = None,
    device=None,
    coalesce: bool = False,
    dtype=np.float64,
) -> List[TileBatch]:
    """Build padded TileBatches from per-expert row-index sets.

    Parameters
    ----------
    coords: [Ntot, D] raw observation coordinates (unscaled).
    obs: [Ntot] raw observation values.
    tile_indices: per-expert integer row indices into coords/obs.
    pred_coords: per-expert [P_i, D] raw prediction coordinates.
    expert_index: per-expert identifier carried into results (default arange).
    coords_scale: optional [D] divisor applied to coords and pred coords
        (ref: base_model.py:243 ``coords /= coords_scale``).
    obs_mean: None (no de-meaning) or 'local' (subtract per-tile mean,
        ref: base_model.py:195-198).
    max_batch_size: optional cap on experts per batch (memory control).
    memory_cap: also cap each bucket at ``auto_batch_cap(nmax, device)``,
        for cores with [B, Nmax, Nmax]-sized live buffers (dense exact GPR),
        sized for f32 compute. The cap is None on the CPU, so there it
        changes nothing.
    cap_width: the width W of the [B, W, W] live buffers the cap sizes for
        instead of nmax (an inter-domain core's padded feature count).
    expert_locs: optional [E, D] raw expert locations; scaled like coords
        and carried per tile.
    coalesce: pad every tile to one global (nmax, pmax), so the whole expert
        set runs as the fewest programs of one shape; a memory cap then
        splits it evenly, every split padded to the same B.
    """
    E = len(tile_indices)
    assert len(pred_coords) == E
    if expert_index is None:
        expert_index = np.arange(E)
    expert_index = np.asarray(expert_index)

    coords = np.asarray(coords, dtype=dtype)
    obs = np.asarray(obs, dtype=dtype).reshape(len(coords))
    if coords_scale is not None:
        coords = coords / np.asarray(coords_scale, dtype=dtype)
    if expert_locs is not None:
        expert_locs = np.asarray(expert_locs, dtype=dtype).reshape(E, coords.shape[1])
        if coords_scale is not None:
            expert_locs = expert_locs / np.asarray(coords_scale, dtype=dtype)

    sizes = np.array([len(ix) for ix in tile_indices])
    order = np.argsort(sizes, kind="stable")  # group similar sizes together

    forced_nmax = forced_pmax = None
    if coalesce and E:
        forced_nmax = bucket_size(int(sizes.max()))
        forced_pmax = bucket_size(int(max(max(len(pc), 1) for pc in pred_coords)), multiple=8)

    def batch_cap(nmax):
        cap = auto_batch_cap(cap_width or nmax, device) if memory_cap else None
        if max_batch_size:
            cap = max_batch_size if cap is None else min(cap, max_batch_size)
        return cap

    batches: List[TileBatch] = []
    current: List[int] = []
    current_bucket = None

    def flush(group: List[int]):
        if not group:
            return
        nmax = forced_nmax or bucket_size(int(max(sizes[g] for g in group)))
        # the prediction axis shares the power-of-two bucket rule
        pmax = forced_pmax or bucket_size(int(max(max(len(pred_coords[g]), 1) for g in group)), multiple=8)
        B = len(group)
        D = coords.shape[1]
        X = np.zeros((B, nmax, D), dtype=dtype)
        y = np.zeros((B, nmax), dtype=dtype)
        mask = np.zeros((B, nmax), dtype=dtype)
        Xnew = np.zeros((B, pmax, D), dtype=dtype)
        pmask = np.zeros((B, pmax), dtype=dtype)
        mean = np.zeros((B,), dtype=dtype)
        for b, g in enumerate(group):
            ix = np.asarray(tile_indices[g])
            n = len(ix)
            X[b, :n] = coords[ix]
            yy = obs[ix]
            if obs_mean == "local" and n > 0:
                mean[b] = yy.mean()
                yy = yy - mean[b]
            y[b, :n] = yy
            mask[b, :n] = 1.0
            pc = np.asarray(pred_coords[g], dtype=dtype).reshape(-1, D)
            if coords_scale is not None:
                pc = pc / np.asarray(coords_scale, dtype=dtype)
            p = len(pc)
            Xnew[b, :p] = pc
            pmask[b, :p] = 1.0
        batches.append(
            TileBatch(
                X=X,
                y=y,
                mask=mask,
                Xnew=Xnew,
                pred_mask=pmask,
                obs_mean=mean,
                expert_index=expert_index[np.asarray(group)],
                num_obs=sizes[np.asarray(group)].astype(np.int64),
                expert_loc=None if expert_locs is None else expert_locs[np.asarray(group)],
            )
        )

    if forced_nmax is not None:
        # one global shape: if the cap forces k programs, split evenly and
        # pad every split to the same B (832 + 832, not 1192 + 472)
        cap = batch_cap(forced_nmax)
        group = [int(g) for g in order]
        k = -(-len(group) // cap) if (cap and len(group) > cap) else 1
        B_prog = -(-len(group) // k)
        for i in range(k):
            flush(group[i * B_prog : (i + 1) * B_prog])
        if k > 1:
            batches[-1] = pad_batch_to(batches[-1], B_prog)
        return batches

    for gi in order:
        bkt = bucket_size(int(sizes[gi]))
        cap = batch_cap(bkt)
        if current and (bkt != current_bucket or (cap and len(current) >= cap)):
            flush(current)
            current = []
        current_bucket = bkt
        current.append(int(gi))
    flush(current)
    return batches


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
