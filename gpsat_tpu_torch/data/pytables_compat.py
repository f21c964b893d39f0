"""Read-only access to pandas-HDFStore (PyTables) files.

The port's own copy of ``gpsat_tpu/data/pytables_compat.py``, plus
``PyTablesStore`` / ``open_store``: the ``TableStore`` read surface
(``keys``, ``in``, ``select``) over such a file, for the orchestrator's
parameter loading. Every file is read through the port's own HDF5 codec
(``data/hdf5.py``): PyTables' compound tables with their array members,
fixed strings, enums, bitfields and pickled attributes, chunked under
any chunk index (version-4 layouts included) and zlib-, lzf-, blosc- or
bzip2-compressed; no h5py. pandas is imported when a file is read.

The reference writes all observation/result stores with pandas HDFStore in
PyTables "table" format (ref: GPSat/local_experts.py:499-550 buffered
appends; GPSat/read_and_store.py:252-260 obs ingest). PyTables is not in
this image, but the on-disk layout is plain HDF5:

  /<key>                      group; attrs: pandas_type=b"frame_table",
                              encoding, data_columns, ...
  /<key>/table                one compound (structured) dataset:
    fields                    "index" (or one field per MultiIndex level),
                              "values_block_<i>" ([n, k] subarray fields),
                              plus one scalar field per data_column
    attrs                     FIELD_<j>_NAME, <field>_kind (a pickled list
                              of the pandas column names that live in that
                              block), <field>_dtype, NROWS, ...

This module parses that structure into DataFrames so a GPSat user's
existing files load without the pytables package. Scope: read-only,
"table" (appendable) format frames — the format every GPSat-produced
store uses; the legacy "fixed" format raises with guidance.

Security note: PyTables stores block-to-column metadata as Python pickles
inside HDF5 attributes; reading a store therefore unpickles those small
metadata lists (same trust model as pandas.read_hdf itself).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from gpsat_tpu_torch.data import hdf5


def _attr(obj, name, default=None):
    v = obj.attrs.get(name, default)
    if isinstance(v, bytes):
        try:
            return v.decode("utf-8")
        except UnicodeDecodeError:
            return v
    return v


def _unpickle_attr(raw):
    """PyTables *_kind attrs are pickled lists of column names."""
    if raw is None:
        return None
    if isinstance(raw, str):
        raw = raw.encode("latin1")
    if isinstance(raw, np.ndarray):
        raw = raw.tobytes()
    try:
        return pickle.loads(raw)
    except Exception:
        return None


def is_pytables_store(path: str) -> bool:
    """True when the file contains pandas_type-tagged PyTables groups; False
    for a file the port's HDF5 codec does not open (not HDF5, or a format
    it does not read)."""
    try:
        return bool(list_tables(path))
    except OSError:
        return False


def list_tables(path: str) -> List[str]:
    """Names of pandas tables in the store (HDFStore .keys() without '/')."""
    with hdf5.File(path, "r") as f:
        return sorted(name for name, grp in f.visit_groups() if "pandas_type" in grp.attrs)


def _decode_kind(vals: np.ndarray, kind: Optional[str], encoding: str):
    if kind and kind.startswith("datetime64"):
        return vals.view("int64").astype("datetime64[ns]")
    if vals.dtype.kind == "S":
        return np.array([v.decode(encoding, errors="replace") for v in vals], dtype=object)
    return vals


def read_table(path: str, key: str, where=None):
    """One PyTables 'table'-format frame -> DataFrame (index restored).

    where: optional list of gpsat where-dicts / strings applied after read
    (the reference pushes these into PyTables query syntax; here the table
    is read then filtered — same results, no query engine needed).
    """
    import pandas as pd

    from gpsat_tpu_torch.data.store import _where_mask

    with hdf5.File(path, "r") as f:
        key = key.lstrip("/")
        assert key in f, f"table: '{key}' not in {path}; available: {list_tables(path)}"
        grp = f[key]
        ptype = _attr(grp, "pandas_type")
        if ptype == "frame":
            raise NotImplementedError(
                f"'{key}' is a fixed-format pandas frame; only 'table' format is "
                "supported (GPSat writes table format). Re-save with format='table'."
            )
        assert ptype == "frame_table", f"unsupported pandas_type: {ptype!r} at {key}"
        encoding = _attr(grp, "encoding", "utf-8") or "utf-8"
        ds = grp["table"]
        data = ds[()]  # structured array

        # FIELD_<j>_NAME gives storage order; index fields precede blocks
        n_fields = len(data.dtype.names)
        field_names = []
        for j in range(n_fields):
            fn = _attr(ds, f"FIELD_{j}_NAME")
            field_names.append(fn if fn is not None else data.dtype.names[j])

        index_arrays: Dict[str, np.ndarray] = {}
        columns: Dict[str, np.ndarray] = {}
        for fn in field_names:
            vals = data[fn]
            kind_raw = ds.attrs.get(f"{fn}_kind")
            if vals.ndim == 2:
                # values block: pickled list of column names in <fn>_kind;
                # <fn>_dtype says what the block holds (datetime64 blocks
                # are stored as int64, string blocks as fixed-width bytes)
                cols = _unpickle_attr(kind_raw)
                if not isinstance(cols, (list, tuple)):
                    cols = [f"{fn}_{i}" for i in range(vals.shape[1])]
                block_dtype = _attr(ds, f"{fn}_dtype")
                if not isinstance(block_dtype, str):
                    block_dtype = None
                for i, c in enumerate(cols):
                    columns[str(c)] = _decode_kind(vals[:, i], block_dtype, encoding)
            else:
                # Two layouts share the scalar-field shape:
                #  - IndexCol: <fn>_kind is a plain kind STRING ("integer",
                #    "datetime64", ...);
                #  - DataCol (a data_column): <fn>_kind is a pickled LIST
                #    of column names (pandas DataCol.set_attr stores
                #    self.values there) and the type lives in <fn>_dtype.
                col_name = fn
                unpickled = _unpickle_attr(kind_raw)
                if isinstance(unpickled, (list, tuple)) and len(unpickled) >= 1:
                    col_name = str(unpickled[0])
                    kind = _attr(ds, f"{fn}_dtype")
                else:
                    kind = kind_raw
                    if isinstance(kind, bytes):
                        kind = kind.decode("utf-8", errors="replace")
                    if isinstance(kind, np.ndarray):
                        kind = None
                decoded = _decode_kind(vals, kind if isinstance(kind, str) else None, encoding)
                if fn == "index" or fn.endswith("_index") or _is_index_field(grp, fn):
                    index_arrays[fn] = decoded
                else:
                    columns[col_name] = decoded  # data_column

    df = pd.DataFrame(columns)
    if index_arrays:
        names = list(index_arrays)
        if names == ["index"]:
            df.index = pd.Index(index_arrays["index"], name=None)
        elif len(names) == 1:
            df.index = pd.Index(index_arrays[names[0]], name=names[0])
        else:
            df.index = pd.MultiIndex.from_arrays(
                [index_arrays[n] for n in names], names=names
            )
    if where is not None:
        if isinstance(where, (str, dict)):
            where = [where]
        work = df.reset_index()
        # np.asarray: pandas-3 extension arrays (StringDtype) -> numpy
        cols = {c: np.asarray(work[c]) for c in work.columns}
        mask = np.ones(len(work), dtype=bool)
        for wd in where:
            mask &= _where_mask(cols, wd)
        df = df.loc[mask]
    return df


def _is_index_field(grp, field_name: str) -> bool:
    """MultiIndex levels are listed in the group's index_cols attr
    (pickled list of (axis, name) pairs)."""
    raw = grp.attrs.get("index_cols")
    cols = _unpickle_attr(raw)
    if not cols:
        return False
    names = [c[1] if isinstance(c, (list, tuple)) else c for c in cols]
    return field_name in names


def read_store(path: str, tables: Optional[List[str]] = None) -> Dict[str, "pd.DataFrame"]:  # noqa: F821
    """Whole reference store -> {table_name: DataFrame}."""
    names = list_tables(path)
    if tables is not None:
        names = [t.lstrip("/") for t in tables]
    return {t: read_table(path, t) for t in names}


class PyTablesStore:
    """A PyTables store behind ``TableStore``'s read surface: ``keys()``,
    ``table in store`` and ``select(table, where=None)`` (the frame with its
    index restored)."""

    def __init__(self, path: str):
        self.path = path
        self._tables = list_tables(path)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def keys(self) -> List[str]:
        return list(self._tables)

    def __contains__(self, table: str) -> bool:
        return table in self._tables

    def select(self, table: str, where=None):
        return read_table(self.path, table, where=where)


def open_store(path: str):
    """A results or observations file for reading: ``PyTablesStore`` for a
    pandas-HDFStore file, the port's ``TableStore`` otherwise."""
    from gpsat_tpu_torch.data.store import TableStore

    return PyTablesStore(path) if is_pytables_store(path) else TableStore(path, mode="r")
