"""Columnar HDF5 table store for results and observations.

The port's own copy of ``gpsat_tpu/data/store.py::TableStore``. The file
format is the same, so a store written by one package reads in the other:
each table is an HDF5 group with one resizable chunked dataset per column, a
``dtype_tag`` attribute on each, and the column and index names as JSON
attributes of the group. DataFrames round-trip with their (multi-)index.

The file is read and written by the port's own HDF5 codec, ``data/hdf5.py``
(numpy and ``struct``), whether or not an HDF5 library is installed, so a
store opens wherever numpy does. pandas is imported when a table is
selected, not when this module is imported, so the orchestrator's
device-facing sweep runs without it. A pandas-HDFStore (PyTables) file
reads through ``data/pytables_compat``.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Union

import numpy as np

from gpsat_tpu_torch.data import hdf5

_ATTR_PREFIX = "gpsat_attr_"


def _where_mask(cols: Dict[str, np.ndarray], wd) -> np.ndarray:
    """Evaluate one where condition against column arrays.

    Accepts the dict DSL {col, comp, val[, negate]} (ref:
    GPSat/dataloader.py:1840-1850) or strings like "x == 5" / "date >= '2020-03-05'".
    """
    if isinstance(wd, str):
        m = re.match(r"\s*([\w\.\-]+)\s*(==|>=|<=|>|<|!=)\s*(.+?)\s*$", wd)
        assert m, f"could not parse where string: {wd}"
        col, comp, val = m.group(1), m.group(2), m.group(3)
        val = val.strip()
        if (val.startswith("'") and val.endswith("'")) or (val.startswith('"') and val.endswith('"')):
            val = val[1:-1]
        else:
            try:
                val = json.loads(val)
            except json.JSONDecodeError:
                pass
        wd = {"col": col, "comp": comp, "val": val}

    wd = dict(wd)
    negate = wd.pop("negate", False)
    col, comp, val = wd["col"], wd["comp"], wd["val"]
    assert col in cols, f"where col: {col} not in table columns: {sorted(cols)}"
    x = cols[col]
    if np.issubdtype(x.dtype, np.datetime64) and isinstance(val, str):
        val = np.datetime64(val)
    if isinstance(val, list):
        assert comp in ("==", "in"), f"list-valued where requires '==' / 'in', got {comp}"
        out = np.isin(x, np.asarray(val))
    else:
        ops = {
            "==": np.equal,
            "!=": np.not_equal,
            ">=": np.greater_equal,
            "<=": np.less_equal,
            ">": np.greater,
            "<": np.less,
        }
        assert comp in ops, f"comp: {comp} is not valid"
        out = ops[comp](x, val)
    return ~out if negate else out


class TableStore:
    """Append/select table store over a single HDF5 file."""

    def __init__(self, path: str, mode: str = "a"):
        self.path = path
        self._h5 = hdf5.File(path, mode)

    # --- lifecycle ---
    def close(self):
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def keys(self) -> List[str]:
        return sorted(self._h5.keys())

    def __contains__(self, table: str) -> bool:
        return table in self._h5

    # --- write ---
    def append(self, table: str, df):
        """Append a DataFrame; creates the table on first append.

        The (multi-)index is stored as ordinary columns and its names in
        attrs, mirroring HDFStore's table format.
        """
        index_names = [n for n in df.index.names if n is not None]
        if index_names:
            df = df.reset_index()
        if table not in self._h5:
            grp = self._h5.create_group(table)
            grp.attrs["columns"] = json.dumps(list(map(str, df.columns)))
            grp.attrs["index_cols"] = json.dumps(index_names)
            for c in df.columns:
                vals, tag = self._encode(df[c].values)
                ds = grp.create_dataset(str(c), vals)
                ds.attrs["dtype_tag"] = tag
        else:
            grp = self._h5[table]
            existing = json.loads(grp.attrs["columns"])
            new_cols = [c for c in map(str, df.columns) if c not in existing]
            missing = [c for c in existing if c not in set(map(str, df.columns))]
            assert not new_cols and not missing, (
                f"schema mismatch appending to '{table}': new columns {new_cols}, missing {missing}"
            )
            n_old = grp[existing[0]].shape[0]
            for c in df.columns:
                vals, tag = self._encode(df[c].values)
                ds = grp[str(c)]
                tag_old = ds.attrs["dtype_tag"]

                def _kind(t):
                    try:
                        return np.dtype(t).kind
                    except TypeError:
                        return "?"

                k_old, k_new = _kind(tag_old), _kind(tag)
                if tag_old != tag and not (k_old == "f" and k_new == "f"):
                    # numeric int<->float cross-appends are reconciled like
                    # HDFStore would (needed e.g. to restart against stores
                    # written before a column widened from int to float)
                    numeric = {k_old, k_new} <= {"i", "u", "f"}
                    assert numeric, f"dtype mismatch on column {c}: {tag_old} vs {tag}"
                    integral = np.all(np.isfinite(vals)) and np.all(vals == np.trunc(vals))
                    # lossless only if the cast round-trips: a negative int
                    # into an unsigned column, or an int wider than the
                    # stored dtype, must promote the column instead of
                    # silently wrapping
                    cast = vals.astype(ds.dtype) if (k_old == "f" or integral) else None
                    if cast is not None and (k_old == "f" or np.array_equal(cast.astype(vals.dtype), vals)):
                        vals = cast
                    else:
                        # promote the stored int column to float in place
                        old = ds.read().astype(vals.dtype)
                        del grp[str(c)]
                        ds = grp.create_dataset(str(c), old)
                        ds.attrs["dtype_tag"] = tag
                ds.append(vals)

    def put(self, table: str, df, replace: bool = True):
        if replace and table in self._h5:
            del self._h5[table]
        self.append(table, df)

    def delete(self, table: str):
        if table in self._h5:
            del self._h5[table]

    # --- read ---
    def select(
        self,
        table: str,
        where: Optional[Union[list, str, dict]] = None,
        columns: Optional[List[str]] = None,
        set_index: bool = True,
    ):
        import pandas as pd

        assert table in self._h5, f"table: '{table}' not in store; available: {self.keys()}"
        grp = self._h5[table]
        all_cols = json.loads(grp.attrs["columns"])
        index_cols = json.loads(grp.attrs["index_cols"])

        if where is not None:
            if isinstance(where, (str, dict)):
                where = [where]
            # decode only the columns the predicates touch, build the row
            # mask, then read the requested columns through it
            needed = set()
            for wd in where:
                if isinstance(wd, dict):
                    needed.add(wd["col"])
                else:
                    m = re.match(r"\s*([\w\.\-]+)", str(wd))
                    assert m, f"could not parse where string: {wd}"
                    needed.add(m.group(1))
            cache = {c: self._decode(grp[c].read(), grp[c].attrs["dtype_tag"]) for c in needed}
            n_rows = grp[all_cols[0]].shape[0] if all_cols else 0
            mask = np.ones(n_rows, dtype=bool)
            for wd in where:
                mask &= _where_mask(cache, wd)
            data = {
                c: (cache[c][mask] if c in cache else self._decode(grp[c].read(), grp[c].attrs["dtype_tag"])[mask])
                for c in (columns or all_cols)
            }
        else:
            data = {c: self._decode(grp[c].read(), grp[c].attrs["dtype_tag"]) for c in (columns or all_cols)}

        df = pd.DataFrame(data)
        if set_index and index_cols and all(c in df.columns for c in index_cols):
            df = df.set_index(index_cols)
        return df

    def get(self, table: str):
        return self.select(table)

    # --- attrs ---
    def put_attrs(self, table: str, **attrs):
        if table not in self._h5:
            self._h5.create_group(table)
        for k, v in attrs.items():
            self._h5[table].attrs[_ATTR_PREFIX + k] = json.dumps(v, default=str)

    def get_attrs(self, table: str) -> dict:
        if table not in self._h5:
            return {}
        out = {}
        for k, v in self._h5[table].attrs.items():
            if k.startswith(_ATTR_PREFIX):
                out[k[len(_ATTR_PREFIX):]] = json.loads(v)
        return out

    # --- codec ---
    @staticmethod
    def _encode(vals):
        # pandas 3 extension arrays (ArrowStringArray etc.) -> numpy first
        if not isinstance(vals, np.ndarray):
            vals = np.asarray(vals)
        if np.issubdtype(vals.dtype, np.datetime64):
            # keep the original unit (pandas 3 defaults to us) in the tag
            return vals.astype(np.int64), str(vals.dtype)
        if vals.dtype == object or vals.dtype.kind in ("U", "S"):
            # variable-length UTF-8 strings in the file
            return np.array([("" if v is None else str(v)) for v in vals], dtype=object), "str"
        if vals.dtype == bool:
            return vals.astype(np.uint8), "bool"
        return vals, vals.dtype.str

    @staticmethod
    def _decode(vals: np.ndarray, tag: str) -> np.ndarray:
        if tag.startswith("datetime64"):
            return vals.astype(tag)
        if tag == "str":
            return vals  # the codec decodes variable-length strings to str
        if tag == "bool":
            return vals.astype(bool)
        return vals
