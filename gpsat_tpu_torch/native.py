"""ctypes bindings of the C++ host library (``csrc/host/gpsat_native.cpp``).

The port's own copy of ``gpsat_tpu/native.py``. The library is built with
g++ at first use by ``ops/_build.py`` (``python -m gpsat_tpu_torch.
build_native`` builds it ahead of time) into the gitignored
``gpsat_tpu_torch/build/``. A failed build raises: no function here falls
back to numpy or scipy on its own. The plain versions stay, chosen by an
explicit argument: ``radius_query_all(..., index="kdtree")`` is scipy's
``cKDTree``, ``data/prediction_locations.max_dist_bool`` the numpy mask,
``data/blosc``'s ``decoder="python"`` the pure-Python codecs.
``HAS_NATIVE``, the JAX module's report of which path is live, builds the
library when read and is then True (there is no other path).

The host library holds:
  - ``max_dist_bool``: the strict euclidean-ball mask (d < r) of the
    reference's numba kernel (ref: GPSat/prediction_locations.py:18-43);
  - ``gaussian_2d_weight``: the NaN-aware Gaussian weighted mean (ref:
    GPSat/postprocessing.py:22-52);
  - ``inverse_softplus`` / ``inverse_sigmoid`` (ref: GPSat/utils.py:
    2329-2356, 2386-2394);
  - the grid-hash radius index (``GridIndex``, ``radius_query_all``): one
    build, then every expert's query in parallel, in place of one KDTree
    query per expert (ref: GPSat/dataloader.py:2354-2447);
  - the blosc codec loops ``lz4_decompress``, ``blosclz_decompress`` and
    ``byte_unshuffle``;
  - ``lzf_decompress``, the loop of h5py's lzf filter (``data/lzf.py``);
  - ``lookup3``, HDF5's metadata checksum (``data/hdf5_structures.py``).

Every index is a handle of its own, so host threads (one per shard of a
mesh, ``parallel/engine.run_on_mesh``) may build and query indices at once.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from gpsat_tpu_torch.ops import _build

LIBRARY = "gpsat_native"
ABI_VERSION = 6
INDEXES = ("grid", "kdtree")

_d = ctypes.POINTER(ctypes.c_double)
_u8 = ctypes.POINTER(ctypes.c_uint8)
_i64 = ctypes.POINTER(ctypes.c_int64)
_SYMBOLS = {
    "gpsat_abi_version": ((), ctypes.c_int64),
    "gpsat_max_dist_bool": ((_d, ctypes.c_int64, ctypes.c_int64, _d, ctypes.c_double, _u8), None),
    "gpsat_gaussian_2d_weight": ((_d, _d, ctypes.c_int64, _d, _d, _d, ctypes.c_int64, ctypes.c_double,
                                  ctypes.c_double, _d), None),
    "gpsat_inverse_softplus": ((_d, ctypes.c_int64, ctypes.c_double, _d), None),
    "gpsat_inverse_sigmoid": ((_d, ctypes.c_int64, ctypes.c_double, ctypes.c_double, _d), None),
    "gpsat_grid_index_build": ((_d, _d, ctypes.c_int64, ctypes.c_double), ctypes.c_void_p),
    "gpsat_grid_index_query": ((ctypes.c_void_p, _d, _d, ctypes.c_int64, ctypes.c_double, ctypes.c_int,
                                ctypes.c_int, _i64, _i64), None),
    "gpsat_grid_index_free": ((ctypes.c_void_p,), None),
    "gpsat_lz4_decompress": ((_u8, ctypes.c_int64, _u8, ctypes.c_int64), ctypes.c_int64),
    "gpsat_byte_unshuffle": ((_u8, ctypes.c_int64, ctypes.c_int64, _u8), None),
    "gpsat_blosclz_decompress": ((_u8, ctypes.c_int64, _u8, ctypes.c_int64), ctypes.c_int64),
    "gpsat_lzf_decompress": ((_u8, ctypes.c_int64, _u8, ctypes.c_int64), ctypes.c_int64),
    "gpsat_lookup3": ((ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32), ctypes.c_uint32),
}


def library() -> ctypes.CDLL:
    """The host library, built with g++ at first use; raises if the build
    fails or the library is of another ABI."""
    lib = _build.load_host_library(LIBRARY, _SYMBOLS)
    built = int(lib.gpsat_abi_version())
    if built != ABI_VERSION:
        raise RuntimeError(f"{LIBRARY} has ABI v{built}, this module binds v{ABI_VERSION}")
    return lib


def __getattr__(name):
    # the JAX module's HAS_NATIVE reports whether its library loaded or its
    # numpy fallbacks are live; the port has no fallback, so the flag builds
    # the library (raising as ``library()`` does) and is then True
    if name == "HAS_NATIVE":
        library()
        return True
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def check_index(index: str) -> str:
    if index not in INDEXES:
        raise ValueError(f"index must be one of {INDEXES}, got {index!r}")
    return index


def max_dist_bool(locs: np.ndarray, ref: np.ndarray, max_dist: float) -> np.ndarray:
    """Strict euclidean-ball mask ||locs[i] - ref|| < max_dist over [n, d]
    rows (threaded C++)."""
    locs = _f64(locs)
    ref = _f64(np.asarray(ref, dtype=np.float64).reshape(-1))
    out = np.empty(locs.shape[0], dtype=np.uint8)
    library().gpsat_max_dist_bool(_ptr(locs, ctypes.c_double), locs.shape[0], locs.shape[1],
                                  _ptr(ref, ctypes.c_double), float(max_dist), _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def gaussian_2d_weight(x0, y0, x, y, l_x: float, l_y: float, vals) -> np.ndarray:
    """NaN-aware Gaussian weighted mean of ``vals`` onto the targets (x0, y0)
    (threaded C++, f64); ``postprocess.gaussian_2d_weight`` is the same sum
    on a torch device."""
    x0, y0, x, y, vals = (_f64(a) for a in (x0, y0, x, y, vals))
    out = np.empty(len(x0), dtype=np.float64)
    library().gpsat_gaussian_2d_weight(
        _ptr(x0, ctypes.c_double), _ptr(y0, ctypes.c_double), len(x0), _ptr(x, ctypes.c_double),
        _ptr(y, ctypes.c_double), _ptr(vals, ctypes.c_double), len(x), float(l_x), float(l_y),
        _ptr(out, ctypes.c_double))
    return out


def inverse_softplus(y, shift: float = 0.0) -> np.ndarray:
    """Stable inverse of softplus(x) + shift; -inf at or below ``shift``."""
    y = _f64(y)
    out = np.empty(y.size, dtype=np.float64)
    library().gpsat_inverse_softplus(_ptr(y, ctypes.c_double), y.size, float(shift), _ptr(out, ctypes.c_double))
    return out.reshape(y.shape)


def inverse_sigmoid(y, low: float = 0.0, high: float = 1.0) -> np.ndarray:
    """Inverse of the sigmoid scaled to (low, high); -inf / +inf outside."""
    y = _f64(y)
    out = np.empty(y.size, dtype=np.float64)
    library().gpsat_inverse_sigmoid(_ptr(y, ctypes.c_double), y.size, float(low), float(high),
                                    _ptr(out, ctypes.c_double))
    return out.reshape(y.shape)


class GridIndex:
    """A grid-hash index over 2-d points with square cells of side ``cell``
    (a handle into the host library; ``close`` or a ``with`` block frees
    it). A query scans the (2 ceil(r / cell) + 1)^2 cells around each
    expert."""

    def __init__(self, coords_xy: np.ndarray, cell: float):
        coords_xy = _f64(coords_xy)
        if coords_xy.ndim != 2 or coords_xy.shape[1] != 2:
            raise ValueError(f"the grid index takes [n, 2] coordinates, got {coords_xy.shape}")
        if not cell > 0:
            raise ValueError(f"the grid index needs a positive cell size, got {cell}")
        self._lib = library()
        x, y = _f64(coords_xy[:, 0]), _f64(coords_xy[:, 1])
        self.n = len(x)
        self._handle = self._lib.gpsat_grid_index_build(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                                                        self.n, float(cell))
        if not self._handle:
            raise RuntimeError("gpsat_grid_index_build returned no index")

    def query(self, expert_xy: np.ndarray, radius: float, *, inclusive: bool = True) -> List[np.ndarray]:
        """Per-expert indices of the points within ``radius`` (d <= r when
        ``inclusive``, else d < r), in the index's cell order."""
        if self._handle is None:
            raise ValueError("the grid index is closed")
        expert_xy = _f64(np.atleast_2d(expert_xy))
        ex, ey = _f64(expert_xy[:, 0]), _f64(expert_xy[:, 1])
        E = len(ex)
        inc = 1 if inclusive else 0
        counts = np.zeros(E, dtype=np.int64)
        self._lib.gpsat_grid_index_query(self._handle, _ptr(ex, ctypes.c_double), _ptr(ey, ctypes.c_double), E,
                                         float(radius), 0, inc, _ptr(counts, ctypes.c_int64), None)
        offsets = np.zeros(E, dtype=np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        flat = np.empty(int(counts.sum()), dtype=np.int64)
        self._lib.gpsat_grid_index_query(self._handle, _ptr(ex, ctypes.c_double), _ptr(ey, ctypes.c_double), E,
                                         float(radius), 1, inc, _ptr(offsets, ctypes.c_int64),
                                         _ptr(flat, ctypes.c_int64))
        return [flat[offsets[e]: offsets[e] + counts[e]] for e in range(E)]

    def close(self):
        if self._handle is not None:
            self._lib.gpsat_grid_index_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()


def _kdtree_query(coords_xy, expert_xy, radius, inclusive) -> List[np.ndarray]:
    """The plain version: scipy's ball query (d <= r), then d < r kept for
    the strict rule."""
    from scipy.spatial import cKDTree

    tree = cKDTree(coords_xy)
    out = []
    for e, ix in enumerate(tree.query_ball_point(expert_xy, radius)):
        ix = np.asarray(ix, dtype=np.int64)
        if not inclusive and len(ix):
            d2 = ((coords_xy[ix] - expert_xy[e]) ** 2).sum(axis=1)
            ix = ix[d2 < radius * radius]
        out.append(ix)
    return out


def radius_query_all(coords_xy: np.ndarray, expert_xy: np.ndarray, radius: float, *, inclusive: bool = True,
                     index: str = "grid") -> List[np.ndarray]:
    """Per-expert sorted index arrays of the points within ``radius``.

    ``inclusive`` selects the boundary rule, on which the reference is split:
    True = d <= r (scipy's ``query_ball_point``, the local-select convention,
    ref: GPSat/dataloader.py:2437-2440); False = d < r (the ``_max_dist_bool``
    prediction-location convention, ref: GPSat/prediction_locations.py:
    18-43). ``index`` "grid" is the C++ grid-hash index (cell = radius,
    built once, every expert queried in parallel); "kdtree" the plain
    version, scipy's ``cKDTree``, for points of any dimension. Both give
    the same sorted sets.
    """
    check_index(index)
    coords_xy = _f64(coords_xy)
    expert_xy = _f64(np.atleast_2d(expert_xy))
    radius = float(radius)
    if index == "kdtree":
        return [np.sort(ix) for ix in _kdtree_query(coords_xy, expert_xy, radius, inclusive)]
    if not radius > 0:
        raise ValueError(f"the grid index needs a positive radius, got {radius}")
    with GridIndex(coords_xy, radius) as grid:
        return [np.sort(ix) for ix in grid.query(expert_xy, radius, inclusive=inclusive)]


def _bytes_ptr(buf) -> tuple:
    src = np.frombuffer(buf, dtype=np.uint8)
    return src, _ptr(src, ctypes.c_uint8)


def lz4_decompress(buf: bytes, dst_len: int) -> bytes:
    """LZ4 block decode (C++): the hot loop of the blosc frame decoder, since
    zarr's default compressor is Blosc(cname='lz4') (ref:
    GPSat/dataloader.py:60-66). Raises on a corrupt block."""
    src, sp = _bytes_ptr(buf)
    dst = np.empty(dst_len, dtype=np.uint8)
    n = library().gpsat_lz4_decompress(sp, len(src), _ptr(dst, ctypes.c_uint8), dst_len)
    if n != dst_len:
        raise ValueError(f"corrupt lz4 block: decoded {n} of {dst_len} bytes")
    return dst.tobytes()


def blosclz_decompress(buf: bytes, dst_len: int) -> bytes:
    """blosclz stream decode (C++): c-blosc's built-in default codec, which
    older zarr and PyTables-era stores carry. Raises on a corrupt stream."""
    src, sp = _bytes_ptr(buf)
    dst = np.empty(dst_len, dtype=np.uint8)
    n = library().gpsat_blosclz_decompress(sp, len(src), _ptr(dst, ctypes.c_uint8), dst_len)
    if n != dst_len:
        raise ValueError(f"corrupt blosclz stream: decoded {n} of {dst_len} bytes")
    return dst.tobytes()


def lzf_decompress(buf: bytes, dst_len: int) -> bytes:
    """LZF decode (C++) into at most ``dst_len`` bytes: the chunks of h5py's
    lzf filter. Raises on a corrupt or overflowing stream."""
    src, sp = _bytes_ptr(buf)
    dst = np.empty(dst_len, dtype=np.uint8)
    n = library().gpsat_lzf_decompress(sp, len(src), _ptr(dst, ctypes.c_uint8), dst_len)
    if n < 0:
        raise ValueError(f"corrupt lzf stream: it does not decode into {dst_len} bytes")
    return dst[:n].tobytes()


def lookup3(buf: bytes, initval: int = 0) -> int:
    """Jenkins' lookup3 hash of ``buf`` (C++): the checksum that ends every
    structure of HDF5's later formats."""
    return int(library().gpsat_lookup3(bytes(buf), len(buf), initval))


def byte_unshuffle(buf: bytes, typesize: int) -> bytes:
    """Inverse of blosc's byte-shuffle filter over one block (C++); the
    trailing len % typesize bytes pass through."""
    if typesize <= 1:
        return bytes(buf)
    src, sp = _bytes_ptr(buf)
    dst = np.empty(len(src), dtype=np.uint8)
    library().gpsat_byte_unshuffle(sp, len(src), typesize, _ptr(dst, ctypes.c_uint8))
    return dst.tobytes()
