"""netCDF4 reading and writing through the port's own HDF5 codec — no
xarray/netCDF4/h5py dependency.

The port's own copy of ``gpsat_tpu/data/netcdf.py``: the same logic, the
bytes read and written by ``data/hdf5.py`` (superblocks 0 to 3, version-2
object headers, new-style and dense groups, dimension scales, chunked and
filtered variables under any chunk index, committed datatypes, a user
block) where the JAX package goes through h5py. The zarr reader shares
``_decode_cf`` from here.

netCDF4 files ARE HDF5 files: dimensions are HDF5 dimension scales
(CLASS="DIMENSION_SCALE") and each variable's dims are recorded in its
DIMENSION_LIST attribute. This module reproduces the slice of
``xr.open_dataset(path).to_dataframe()`` the reference's ingest relies on
(ref: GPSat/dataloader.py:60-66 engine map, :388-394 nc -> to_dataframe,
:1294-1414 unified load):

- dims become index levels in first-seen order, coordinate variables
  provide the level values (dims without a coordinate variable get a
  0..n-1 integer level);
- data variables are broadcast over the full dim product and flattened in
  C order;
- basic CF decoding: _FillValue/missing_value -> NaN, scale_factor /
  add_offset, and "<unit> since <epoch>" time units -> pandas datetimes
  (standard/gregorian calendars).

Scope: root-group variables (the reference's ESA/GPOD inputs are flat
classic-model files); HDF5 groups raise with a clear message. The
datatypes netCDF-C commits in the root group (a user-defined enum,
compound or vlen type) are not variables and are passed over; the JAX
reader, through h5py, takes them for variables and fails on them unless
``variables`` names what to read.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from gpsat_tpu_torch.data import hdf5

# netCDF4 marks a dimension that has no coordinate variable with this NAME
_PHONY_DIM_PREFIX = b"This is a netCDF dimension but not a netCDF variable"

_TIME_UNIT_MAP = {
    "seconds": "s",
    "second": "s",
    "sec": "s",
    "s": "s",
    "minutes": "m",
    "minute": "m",
    "min": "m",
    "hours": "h",
    "hour": "h",
    "h": "h",
    "days": "D",
    "day": "D",
    "d": "D",
    "milliseconds": "ms",
    "millisecond": "ms",
    "microseconds": "us",
    "microsecond": "us",
    "nanoseconds": "ns",
    "nanosecond": "ns",
}


def _attr(attrs, name, default=None):
    v = attrs.get(name, default)
    if isinstance(v, bytes):
        v = v.decode("utf-8", errors="replace")
    if isinstance(v, np.ndarray) and v.size == 1:
        v = v.reshape(())[()]
        if isinstance(v, bytes):
            v = v.decode("utf-8", errors="replace")
    return v


def _decode_cf(values: np.ndarray, attrs) -> np.ndarray:
    """Apply _FillValue/missing_value masking, scale/offset, time units."""
    fill = attrs.get("_FillValue", None)
    missing = attrs.get("missing_value", None)
    scale = _attr(attrs, "scale_factor")
    offset = _attr(attrs, "add_offset")
    units = _attr(attrs, "units")
    calendar = str(_attr(attrs, "calendar", "standard")).lower()

    masked = None
    if np.issubdtype(values.dtype, np.floating):
        masked = ~np.isfinite(values)
    for mv in (fill, missing):
        if mv is None:
            continue
        mv = np.asarray(mv).reshape(-1)
        hit = np.isin(values, mv)
        masked = hit if masked is None else (masked | hit)

    if scale is not None or offset is not None:
        values = values.astype(np.float64)
        if scale is not None:
            values = values * float(scale)
        if offset is not None:
            values = values + float(offset)

    is_time = isinstance(units, str) and re.match(r"^\s*\w+\s+since\s+", units)
    if is_time and calendar in ("standard", "gregorian", "proleptic_gregorian", "proleptic gregorian"):
        unit_word, epoch = re.split(r"\s+since\s+", units.strip(), maxsplit=1)
        pd_unit = _TIME_UNIT_MAP.get(unit_word.lower())
        if pd_unit is not None:
            base = pd.Timestamp(epoch.strip())
            vals = values.astype(np.float64)
            if masked is not None and masked.any():
                vals = np.where(masked, np.nan, vals)
            return (base + pd.to_timedelta(vals.reshape(-1), unit=pd_unit)).values.reshape(values.shape)

    if masked is not None and masked.any():
        if not np.issubdtype(values.dtype, np.floating):
            values = values.astype(np.float64)
        values = np.where(masked, np.nan, values)
    return values


def _attr_bytes(attrs, name) -> bytes:
    v = attrs.get(name, b"")
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, bytes):
        return v
    if isinstance(v, np.ndarray):
        v = v.reshape(-1)
        return v[0] if len(v) and isinstance(v[0], bytes) else b""
    return b""


def _decode_bytes(vals: np.ndarray) -> np.ndarray:
    """Variable-length strings as bytes objects (h5py's) -> str; the codec
    already gives str."""
    if vals.dtype.kind == "O" and any(isinstance(x, (bytes, bytearray)) for x in vals.reshape(-1)[:1]):
        return np.asarray(
            [x.decode("utf-8", errors="replace") if isinstance(x, (bytes, bytearray)) else x
             for x in vals.reshape(-1)], dtype=object
        ).reshape(vals.shape)
    return vals


def _is_scale(ds) -> bool:
    return _attr_bytes(ds.attrs, "CLASS").startswith(b"DIMENSION_SCALE")


def _dim_names(var, fallback_count: Dict[int, str]) -> List[str]:
    """Dimension names of a dataset via its attached scales; phony
    names (per-length, netCDF4-style phony_dim_N) when none attached."""
    names = []
    for axis, dim in enumerate(var.dims):
        label = None
        # attached scale's dataset name is the dimension name
        for _, scale in dim.items():
            label = scale.name.lstrip("/")
            break
        if label is None:
            n = var.shape[axis]
            if n not in fallback_count:
                fallback_count[n] = f"phony_dim_{len(fallback_count)}"
            label = fallback_count[n]
        names.append(label)
    return names


def read_netcdf(
    path: str,
    variables: Optional[List[str]] = None,
    decode_cf: bool = True,
) -> pd.DataFrame:
    """Read a (root-group) netCDF4/HDF5 file into a DataFrame with the
    dims as index levels — the xarray ``to_dataframe`` contract the
    reference ingest consumes."""
    with hdf5.File(path, "r") as f:
        for key in f.keys():
            if isinstance(f[key], hdf5.Group):
                raise NotImplementedError(
                    f"netCDF file {path} contains HDF5 group '{key}'; only flat "
                    "(classic-model) files are supported by this reader"
                )

        names = [k for k in f.keys() if not isinstance(f[k], hdf5.Datatype)]
        scales = {k: f[k] for k in names if _is_scale(f[k])}
        data_vars = {k: f[k] for k in names if k not in scales}
        if variables is not None:
            missing = [v for v in variables if v not in data_vars and v not in scales]
            if missing:
                raise KeyError(f"variables not in {path}: {missing}")
            data_vars = {k: f[k] for k in variables if k in data_vars}

        # dim sizes + coordinate values
        fallback: Dict[int, str] = {}
        var_dims = {k: _dim_names(v, fallback) for k, v in data_vars.items()}
        dim_order: List[str] = []
        dim_size: Dict[str, int] = {}
        for k, dims in var_dims.items():
            for d, n in zip(dims, data_vars[k].shape):
                if d not in dim_order:
                    dim_order.append(d)
                    dim_size[d] = n
        if variables is not None:
            # a requested COORDINATE (dimension scale) is an index level
            # (xarray to_dataframe semantics); without this its dim —
            # hence its values — would silently vanish when no selected
            # data var covers it
            for v in variables:
                if v in scales and v not in dim_order:
                    dim_order.append(v)
                    dim_size[v] = scales[v].shape[0]

        coords: Dict[str, np.ndarray] = {}
        for d in dim_order:
            if d in scales and not _attr_bytes(scales[d].attrs, "NAME").startswith(_PHONY_DIM_PREFIX):
                vals = _decode_bytes(np.asarray(scales[d][()]))
                coords[d] = _decode_cf(vals, scales[d].attrs) if decode_cf else vals
            else:
                coords[d] = np.arange(dim_size[d])

        columns = {}
        shape_full = tuple(dim_size[d] for d in dim_order)
        for k, v in data_vars.items():
            vals = _decode_bytes(np.asarray(v[()]))
            if decode_cf:
                vals = _decode_cf(vals, v.attrs)
            # broadcast over the full dim product (xarray to_dataframe
            # semantics): place each axis at its dim position
            src = var_dims[k]
            expand = [slice(None) if d in src else None for d in dim_order]
            perm = [src.index(d) for d in dim_order if d in src]
            vals = np.transpose(vals, perm)[tuple(expand)]
            columns[k] = np.broadcast_to(vals, shape_full).reshape(-1)

    if len(dim_order) == 0:
        return pd.DataFrame({k: np.atleast_1d(v) for k, v in columns.items()})
    if len(dim_order) == 1:
        index = pd.Index(coords[dim_order[0]], name=dim_order[0])
    else:
        index = pd.MultiIndex.from_product([coords[d] for d in dim_order], names=dim_order)
    return pd.DataFrame(columns, index=index)


def write_netcdf(path: str, df_or_vars, coords: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a flat netCDF4-style (HDF5 + dimension scales) file through the
    port's HDF5 codec: HDF5's earliest format, contiguous variables, the
    dimension scales as HDF5's H5DS functions lay them out, the file the JAX
    writer makes through h5py. Real netCDF4 readers open these files (the
    dimension-scale layout is the netCDF4 on-disk convention)."""
    if isinstance(df_or_vars, pd.DataFrame) and isinstance(df_or_vars.index, pd.MultiIndex):
        # unstack onto the dense dim product (xarray's df.to_xarray()
        # convention): each index level becomes a dimension, missing cells
        # are NaN
        df = df_or_vars
        levels = list(df.index.names)
        uniq = [np.unique(df.index.get_level_values(l).to_numpy()) for l in levels]
        shape = tuple(len(u) for u in uniq)
        pos = [
            {v: i for i, v in enumerate(u)} for u in uniq
        ]
        idx = tuple(
            np.array([pos[k][v] for v in df.index.get_level_values(l).to_numpy()])
            for k, l in enumerate(levels)
        )
        coords = dict(zip(levels, uniq))
        dense = len(df) == int(np.prod(shape))
        data = {}
        for c in df.columns:
            col = df[c].to_numpy()
            kind = col.dtype.kind
            # missing cells get the column dtype's own null (NaT/None/NaN);
            # dense int/bool columns keep their dtype instead of being
            # demoted to float (xarray to_xarray convention)
            if kind == "M":
                arr = np.full(shape, np.datetime64("NaT"), dtype=col.dtype)
            elif kind == "m":
                arr = np.full(shape, np.timedelta64("NaT"), dtype=col.dtype)
            elif kind in "OUS":
                arr = np.full(shape, None, dtype=object)
            elif dense and kind not in "fc":
                arr = np.zeros(shape, dtype=col.dtype)
            else:
                arr = np.full(shape, np.nan, dtype=float)
            arr[idx] = col
            data[c] = (tuple(levels), arr)
    elif isinstance(df_or_vars, pd.DataFrame):
        coords = {"index": df_or_vars.index.to_numpy()}
        data = {c: ("index", df_or_vars[c].to_numpy()) for c in df_or_vars.columns}
    else:
        data = df_or_vars
        coords = coords or {}

    def encode(vals):
        """HDF5 has no datetime64/unicode dtypes: CF-encode datetimes
        (int64 ns + units attr, NaT -> _FillValue, round-tripped by
        _decode_cf) and write strings variable-length."""
        vals = np.asarray(vals)
        if vals.dtype.kind == "M":
            ints = vals.astype("datetime64[ns]").astype(np.int64)
            attrs = {"units": "nanoseconds since 1970-01-01",
                     "_FillValue": np.int64(np.iinfo(np.int64).min)}
            return ints, attrs
        if vals.dtype.kind in "OUS":
            out = np.asarray(
                ["" if v is None else str(v) for v in vals.reshape(-1)], dtype=object
            ).reshape(vals.shape)
            return out, {}
        return vals, {}

    with hdf5.File(path, "w") as f:
        for d, vals in coords.items():
            enc, attrs = encode(vals)
            ds = f.create_dataset(d, enc, contiguous=True)
            for k, v in attrs.items():
                ds.attrs[k] = v
            ds.make_scale(d)
        for name, (dims, vals) in data.items():
            dims = (dims,) if isinstance(dims, str) else tuple(dims)
            enc, attrs = encode(vals)
            ds = f.create_dataset(name, enc, contiguous=True)
            for k, v in attrs.items():
                ds.attrs[k] = v
            for axis, d in enumerate(dims):
                ds.dims[axis].attach_scale(f[d])
