"""Minimal zarr v2 DirectoryStore reader/writer — stdlib, numpy and pandas.

The port's own copy of ``gpsat_tpu/data/zarr_reader.py``.

The reference loads zarr stores through xarray
(ref: GPSat/dataloader.py:60-66 engine map, :1239-1254 zarr write,
:1294-1414 unified load). Neither zarr nor xarray is in this image, but
the zarr v2 on-disk format is just JSON metadata + per-chunk binary files:

  <store>/.zgroup                    {"zarr_format": 2}
  <store>/<array>/.zarray            shape/chunks/dtype/compressor/...
  <store>/<array>/.zattrs            attributes (xarray stores the dim
                                     names under "_ARRAY_DIMENSIONS")
  <store>/<array>/<i>.<j>...         chunk files, C-order, possibly
                                     zlib/gzip-compressed

This module reads that format directly (codecs: none, zlib, gzip, zstd,
and blosc frames — any cname blosclz/lz4/lz4hc/snappy/zlib/zstd with
byte- or bit-shuffle, via data/blosc.py, whose ``decoder`` argument the
readers pass on: "native" for the C++ host library, "python" for the plain
decoders) and converts an xarray-style
group to the same DataFrame contract as data/netcdf.read_netcdf: dims
become index levels (coordinate arrays supply the values), data variables
broadcast over the dim product in C order. A writer is included so tests
and migrations can produce fixture stores without the zarr package.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

_DIM_ATTR = "_ARRAY_DIMENSIONS"


# --------------------------------------------------------------------------
# array-level read
# --------------------------------------------------------------------------

def _decompress(buf: bytes, compressor: Optional[dict], decoder: str = "native") -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid in ("zlib", "gzip"):
        # zlib.decompress handles both zlib- and gzip-wrapped deflate
        # streams with wbits=47 (auto-detect)
        return zlib.decompress(buf, 47) if cid == "gzip" else zlib.decompress(buf)
    if cid == "zstd":
        import zstandard

        dctx = getattr(_decompress, "_zstd", None)
        if dctx is None:
            dctx = _decompress._zstd = zstandard.ZstdDecompressor()
        # streamed frames carry no content size in the header; decompressobj
        # grows its output to the actual size instead of preallocating a
        # max_output_size bound (a one-shot decompress() would need one)
        return dctx.decompressobj().decompress(buf)
    if cid == "blosc":
        # zarr's DEFAULT compressor (Blosc cname='lz4' shuffle=SHUFFLE) —
        # what reference-era stores actually carry. Frame parser in
        # data/blosc.py; lz4/unshuffle inner loops in the C++ host library.
        from gpsat_tpu_torch.data.blosc import blosc_decode

        return blosc_decode(buf, decoder)
    raise NotImplementedError(
        f"zarr compressor '{cid}' not supported by the built-in reader "
        "(supported: null, zlib, gzip, zstd, blosc); re-write the store "
        "with compressor=zarr.Zlib() or uncompressed"
    )


def read_zarr_array(array_dir: str, decoder: str = "native") -> Tuple[np.ndarray, dict]:
    """One zarr v2 array directory -> (ndarray, attrs)."""
    with open(os.path.join(array_dir, ".zarray")) as f:
        meta = json.load(f)
    assert meta.get("zarr_format") == 2, f"not a zarr v2 array: {array_dir}"
    if meta.get("filters"):
        raise NotImplementedError(f"zarr filters not supported: {meta['filters']}")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    order = meta.get("order", "C")
    fill = meta.get("fill_value", 0)
    if fill is None:
        fill = 0
    compressor = meta.get("compressor")

    out = np.full(shape, fill, dtype=dtype) if shape else np.zeros((), dtype=dtype)
    if shape:
        grid = [int(-(-s // c)) for s, c in zip(shape, chunks)]
        sep = meta.get("dimension_separator", ".")
        for idx in np.ndindex(*grid):
            fname = sep.join(str(i) for i in idx)
            fpath = os.path.join(array_dir, fname)
            if not os.path.exists(fpath):
                continue  # missing chunk = fill_value
            with open(fpath, "rb") as f:
                raw = _decompress(f.read(), compressor, decoder)
            chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
            sl = tuple(
                slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape)
            )
            trim = tuple(slice(0, sl[d].stop - sl[d].start) for d in range(len(shape)))
            out[sl] = chunk[trim]

    attrs = {}
    zattrs = os.path.join(array_dir, ".zattrs")
    if os.path.exists(zattrs):
        with open(zattrs) as f:
            attrs = json.load(f)
    return out, attrs


def _is_zarr_array(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, ".zarray"))


# --------------------------------------------------------------------------
# group -> DataFrame (xarray to_dataframe contract, as in data/netcdf.py)
# --------------------------------------------------------------------------

def read_zarr(path: str, variables: Optional[Sequence[str]] = None, decode_cf: bool = True,
              decoder: str = "native") -> pd.DataFrame:
    """Read an xarray-style zarr v2 group into a DataFrame with dims as
    index levels (mirrors data/netcdf.read_netcdf)."""
    from gpsat_tpu_torch.data.netcdf import _decode_cf

    assert os.path.isdir(path), f"zarr store not found: {path}"
    names = sorted(
        k for k in os.listdir(path) if _is_zarr_array(os.path.join(path, k))
    )
    assert names, f"no zarr arrays found under: {path}"
    # metadata pass first (shape + dims from .zarray/.zattrs, no chunk IO)
    # so only the requested variables' chunks are read and decompressed
    attrs_map: Dict[str, dict] = {}
    dims_map: Dict[str, tuple] = {}
    shape_map: Dict[str, tuple] = {}
    for k in names:
        adir = os.path.join(path, k)
        with open(os.path.join(adir, ".zarray")) as f:
            shape_map[k] = tuple(json.load(f)["shape"])
        attrs = {}
        zattrs = os.path.join(adir, ".zattrs")
        if os.path.exists(zattrs):
            with open(zattrs) as f:
                attrs = json.load(f)
        attrs_map[k] = attrs
        dims_map[k] = tuple(
            attrs.get(_DIM_ATTR, [f"dim_{i}" for i in range(len(shape_map[k]))])
        )

    # coordinate arrays: name == their own (single) dim
    coords = {k for k in names if dims_map[k] == (k,)}
    data_vars = [k for k in names if k not in coords]
    if variables is not None:
        missing = [v for v in variables if v not in names]
        if missing:
            raise KeyError(f"variables not in {path}: {missing}")
        data_vars = [v for v in variables if v not in coords]
        # a requested COORDINATE is an index level (xarray to_dataframe
        # semantics); without this its dim — hence its values — would
        # silently vanish when no selected data var covers it
        extra_dims = [v for v in variables if v in coords]

    dim_order: List[str] = []
    dim_size: Dict[str, int] = {}
    for k in data_vars:
        for d, n in zip(dims_map[k], shape_map[k]):
            if d not in dim_order:
                dim_order.append(d)
                dim_size[d] = n
    if variables is not None:
        for d in extra_dims:
            if d not in dim_order:
                dim_order.append(d)
                dim_size[d] = shape_map[d][0]

    needed = list(data_vars) + [d for d in dim_order if d in coords]
    arrays: Dict[str, np.ndarray] = {
        k: read_zarr_array(os.path.join(path, k), decoder)[0] for k in needed
    }

    coord_vals: Dict[str, np.ndarray] = {}
    for d in dim_order:
        if d in coords:
            v = arrays[d]
            coord_vals[d] = _decode_cf(v, attrs_map[d]) if decode_cf else v
        else:
            coord_vals[d] = np.arange(dim_size[d])

    shape_full = tuple(dim_size[d] for d in dim_order)
    columns = {}
    for k in data_vars:
        vals = arrays[k]
        if decode_cf:
            vals = _decode_cf(vals, attrs_map[k])
        src = dims_map[k]
        expand = [slice(None) if d in src else None for d in dim_order]
        perm = [src.index(d) for d in dim_order if d in src]
        vals = np.transpose(vals, perm)[tuple(expand)]
        columns[k] = np.broadcast_to(vals, shape_full).reshape(-1)

    if not dim_order:
        return pd.DataFrame({k: np.atleast_1d(v) for k, v in columns.items()})
    index = pd.MultiIndex.from_product([coord_vals[d] for d in dim_order], names=dim_order)
    df = pd.DataFrame(columns, index=index)
    if len(dim_order) == 1:
        df.index = pd.Index(coord_vals[dim_order[0]], name=dim_order[0])
    return df


# --------------------------------------------------------------------------
# writer (fixtures / migration; zlib or uncompressed)
# --------------------------------------------------------------------------

def write_zarr_array(array_dir: str, values: np.ndarray, dims: Sequence[str], chunks=None, compress=True,
                     attrs: Optional[dict] = None, shuffle: int = 1):
    """compress: False/None, True/"zlib", "zstd", or "blosc" (zarr's
    default layout: lz4 frames via data/blosc.py, byte-shuffled with
    ``shuffle`` 1, the default, bit-shuffled with 2, unshuffled with 0).

    The advertised blosc config (cname/clevel/shuffle) is nominal: frames
    come from the in-repo greedy lz4 encoder, not c-blosc at clevel 5.
    Self-describing frame headers make this irrelevant to any conformant
    reader; only byte-identity with c-blosc output is not implied."""
    values = np.ascontiguousarray(values)
    codec = {True: "zlib", False: None, None: None}.get(compress, compress)
    assert codec in (None, "zlib", "zstd", "blosc"), f"unsupported codec: {codec}"
    os.makedirs(array_dir, exist_ok=True)
    if chunks is None:
        chunks = tuple(min(s, 1 << 16) for s in values.shape) or ()
    if codec == "blosc":
        comp_meta = {"id": "blosc", "cname": "lz4", "clevel": 5,
                     "shuffle": int(shuffle), "blocksize": 0}
    elif codec:
        comp_meta = {"id": codec, "level": 1}
    else:
        comp_meta = None
    meta = {
        "zarr_format": 2,
        "shape": list(values.shape),
        "chunks": list(chunks),
        "dtype": values.dtype.str,
        "compressor": comp_meta,
        "fill_value": None,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(array_dir, ".zarray"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(array_dir, ".zattrs"), "w") as f:
        json.dump({_DIM_ATTR: list(dims), **(attrs or {})}, f)
    if values.shape:
        grid = [int(-(-s // c)) for s, c in zip(values.shape, chunks)]
        for idx in np.ndindex(*grid):
            sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
            chunk = values[sl]
            # zarr chunk files are always full chunk size (edge chunks padded)
            if chunk.shape != tuple(chunks):
                pad = np.zeros(chunks, dtype=values.dtype)
                pad[tuple(slice(0, s) for s in chunk.shape)] = chunk
                chunk = pad
            raw = np.ascontiguousarray(chunk).tobytes()
            if codec == "zlib":
                raw = zlib.compress(raw, 1)
            elif codec == "zstd":
                import zstandard

                raw = zstandard.ZstdCompressor(level=1).compress(raw)
            elif codec == "blosc":
                from gpsat_tpu_torch.data.blosc import blosc_encode

                raw = blosc_encode(raw, typesize=values.dtype.itemsize, shuffle=int(shuffle))
            with open(os.path.join(array_dir, ".".join(str(i) for i in idx)), "wb") as f:
                f.write(raw)


def write_zarr(path: str, data_vars: Dict[str, Tuple[Sequence[str], np.ndarray]],
               coords: Optional[Dict[str, np.ndarray]] = None, compress: bool = True, shuffle: int = 1,
               chunks=None):
    """Write an xarray-style zarr v2 group.

    data_vars: {name: (dims, values)}; coords: {dim_name: 1-d values};
    ``shuffle`` and ``chunks`` (one per dimension; default whole arrays of
    up to 65,536 per dimension) go to every array.
    """
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    for d, v in (coords or {}).items():
        write_zarr_array(os.path.join(path, d), np.asarray(v), (d,), compress=compress, shuffle=shuffle,
                         chunks=None if chunks is None else tuple(chunks)[:1])
    for k, (dims, v) in data_vars.items():
        v = np.asarray(v)
        write_zarr_array(os.path.join(path, k), v, dims, compress=compress, shuffle=shuffle,
                         chunks=None if chunks is None else tuple(chunks)[:v.ndim])
