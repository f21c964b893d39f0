"""HDF5's serialised dataspace selections for the port's codec (``data/hdf5.py``).

A selection is stored after a region reference's object address (in its
global heap object) and twice in each mapping of a virtual dataset (the
source's and the virtual dataset's), as ``H5S_SELECT_SERIALIZE`` writes it:
a 4-byte type (0 none, 1 points, 2 hyperslabs, 3 all), a 4-byte version,
then

- none and all (version 1): 8 bytes of zeros (reserved, length);
- points, version 1: reserved (4), length (4), rank (4), count (4), each
  point's coordinates (4 bytes each); version 2: the width of what follows
  (1: 2, 4 or 8 bytes), rank (4), count and coordinates at that width;
- hyperslabs, version 1: reserved (4), length (4), rank (4), count (4),
  each block's start and end coordinates (4 bytes each, the end
  inclusive); version 2: flags (1; bit 0 regular), length (4), rank (4),
  each dim's start, stride, count and block (8 bytes each); version 3:
  flags (1), the width (1), rank (4), then regular: each dim's start,
  stride, count and block, else the count of blocks and each block's start
  and end, at that width.

A selection's elements come in HDF5's order: a hyperslab selection's in C
order of their coordinates, each once; a point selection's as its points
are listed. ``RegionReference`` is a region reference's value: the object
it names and its selection.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from gpsat_tpu_torch.data.hdf5_types import UNDEF, FormatError, uint

SEL_NONE, SEL_POINTS, SEL_HYPERSLABS, SEL_ALL = 0, 1, 2, 3


class Selection:
    """A decoded selection: ``kind`` ("none", "all", "points" or
    "hyperslabs"), its ``rank`` (None for none and all) and, for points, the
    coordinates [n, rank]; for hyperslabs either ``regular`` (start, stride,
    count, block per dim) or ``blocks`` [n, 2, rank] (start and inclusive
    end)."""

    def __init__(self, kind: str, rank: Optional[int] = None, points=None, regular=None, blocks=None):
        self.kind, self.rank = kind, rank
        self.points, self.regular, self.blocks = points, regular, blocks

    @property
    def unlimited(self) -> bool:
        """Whether a regular hyperslab runs on without end (a count or a
        block of H5S_UNLIMITED): an unlimited virtual mapping."""
        return self.regular is not None and any(c == UNDEF or b == UNDEF for _, _, c, b in self.regular)

    def index(self, shape: Tuple[int, ...]):
        """A numpy index of the selected elements of an array of ``shape``,
        and whether it is a grid (an ``np.ix_`` of one index per dim: the
        elements in C order) or points (one array of coordinates per dim)."""
        rank = len(shape)
        if self.kind == "all":
            return np.ix_(*(np.arange(n) for n in shape)), True
        if self.kind == "none" or (self.blocks is not None and not len(self.blocks)):
            return tuple(np.zeros(0, np.int64) for _ in range(rank)), False
        if self.rank != rank:
            raise FormatError(f"a selection of rank {self.rank} over a dataspace of rank {rank}")
        if self.unlimited:
            raise FormatError("an unlimited selection (a count or block of H5S_UNLIMITED)")
        if self.kind == "points":
            return tuple(self.points.T), False
        if self.regular is not None:
            axes = [np.unique((start + stride * np.arange(count))[:, None] + np.arange(block)[None, :])
                    for start, stride, count, block in self.regular]
            return np.ix_(*axes), True
        if len(self.blocks) == 1:  # one block: a box
            lo, hi = self.blocks[0]
            return np.ix_(*(np.arange(a, b + 1) for a, b in zip(lo, hi))), True
        coords = np.concatenate([np.stack([g.reshape(-1) for g in np.meshgrid(
            *(np.arange(a, b + 1) for a, b in zip(lo, hi)), indexing="ij")], axis=1) for lo, hi in self.blocks])
        coords = np.unique(coords, axis=0)  # each once, in C order (np.unique sorts rows lexicographically)
        return tuple(coords.T), False

    def take(self, arr: np.ndarray) -> np.ndarray:
        """The selected elements of ``arr``, in order, as a 1-D array."""
        ix, _ = self.index(arr.shape)
        return arr[ix].reshape(-1)

    def put(self, arr: np.ndarray, values: np.ndarray) -> None:
        """Write ``values`` (as many as are selected, in order) into the
        selected elements of ``arr``."""
        ix, grid = self.index(arr.shape)
        if grid:
            arr[ix] = values.reshape(arr[ix].shape)
        else:
            arr[ix] = values

    def shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape h5py gives the elements selected from a dataset of
        ``shape`` (``h5py._hl.selections.guess_shape``): the dataset's for
        all, (0,) * rank for none, (n,) for points, and for hyperslabs the
        elements along each axis where their product is n, else (n,)."""
        if self.kind == "all":
            return tuple(shape)
        if self.kind == "none":
            return (0,) * len(shape)
        ix, grid = self.index(shape)
        if self.kind == "points":
            return (len(ix[0]),)
        if grid:
            return tuple(a.size for a in ix)
        coords = np.stack(ix, axis=1)
        n = len(coords)
        if not n:
            return (0,) * len(shape)
        # h5py masks off all but the lowest coordinate along an axis and divides
        per_axis = tuple(n // int(np.sum(coords[:, d] == coords[:, d].min())) for d in range(coords.shape[1]))
        return per_axis if int(np.prod(per_axis)) == n else (n,)


def _ints(buf: bytes, pos: int, n: int, width: int) -> Tuple[np.ndarray, int]:
    """``n`` little-endian unsigned integers of ``width`` bytes at ``pos``,
    all ones read as UNDEF; and the position after them."""
    raw = np.frombuffer(buf, np.uint8, n * width, pos).reshape(n, width).astype(np.uint64)
    vals = np.zeros(n, np.uint64)
    for k in range(width):
        vals |= raw[:, k] << np.uint64(8 * k)
    vals[vals == np.uint64((1 << 8 * width) - 1)] = np.uint64(UNDEF)
    return vals, pos + n * width


def parse_selection(buf: bytes, pos: int = 0) -> Tuple[Selection, int]:
    """The serialised selection at ``buf[pos:]`` and the position after it."""
    kind, version = struct.unpack_from("<II", buf, pos)
    pos += 8
    if kind in (SEL_NONE, SEL_ALL):
        if version != 1:
            raise FormatError(f"a selection of type {kind}, version {version}")
        return Selection("none" if kind == SEL_NONE else "all"), pos + 8
    if kind == SEL_POINTS:
        if version == 1:
            rank, n = struct.unpack_from("<II", buf, pos + 8)
            width, pos = 4, pos + 16
        elif version == 2:
            width, rank = buf[pos], struct.unpack_from("<I", buf, pos + 1)[0]
            n, pos = uint(buf, pos + 5, width), pos + 5 + width
        else:
            raise FormatError(f"a point selection of version {version}")
        coords, pos = _ints(buf, pos, n * rank, width)
        return Selection("points", rank, points=coords.astype(np.int64).reshape(n, rank)), pos
    if kind != SEL_HYPERSLABS:
        raise FormatError(f"a selection of type {kind}")
    if version == 1:
        rank, n = struct.unpack_from("<II", buf, pos + 8)
        vals, pos = _ints(buf, pos + 16, n * 2 * rank, 4)
        return Selection("hyperslabs", rank, blocks=vals.astype(np.int64).reshape(n, 2, rank)), pos
    if version == 2:  # always regular, 8 bytes a value
        flags, rank = buf[pos], struct.unpack_from("<I", buf, pos + 5)[0]
        width, pos = 8, pos + 9
    elif version == 3:
        flags, width, rank = buf[pos], buf[pos + 1], struct.unpack_from("<I", buf, pos + 2)[0]
        pos += 6
    else:
        raise FormatError(f"a hyperslab selection of version {version}")
    if flags & 1:
        vals, pos = _ints(buf, pos, 4 * rank, width)
        regular: List[Tuple[int, int, int, int]] = [tuple(int(v) for v in vals[4 * d:4 * d + 4]) for d in range(rank)]
        return Selection("hyperslabs", rank, regular=regular), pos
    if version == 2:
        raise FormatError("an irregular hyperslab selection of version 2")
    n, pos = uint(buf, pos, width), pos + width
    vals, pos = _ints(buf, pos, n * 2 * rank, width)
    return Selection("hyperslabs", rank, blocks=vals.astype(np.int64).reshape(n, 2, rank)), pos


class RegionReference:
    """A region reference's value (h5py's ``RegionReference``): the address
    of the object header it names and its ``selection``. ``file[ref]`` is
    that object; ``dataset[ref]`` the selected elements, in h5py's order
    and shape."""

    __slots__ = ("addr", "selection")

    def __init__(self, addr: int, selection: Selection):
        self.addr, self.selection = addr, selection

    def __repr__(self):
        return f"RegionReference(addr={self.addr}, {self.selection.kind})"
