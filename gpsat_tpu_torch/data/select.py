"""Data-selection DSL — where dicts, row selection, local radius selection.

The port's own copy of the parts of ``gpsat_tpu/data/select.py`` the
orchestrator uses (ref: GPSat/dataloader.py):
  - ``bool_array_from_where`` (:1887-1970): {col, comp, val[, negate]}
    simple comparisons, falling back to config_func specs
  - ``row_select_bool`` (:137-232): AND/OR combination
  - ``local_select_indices_all`` (:2354-2447, all experts at once): scalar
    offsets from an expert location plus a radius query for multi-column
    entries
  - ``get_where_list`` (:2893-2978): static + dynamic global selects

  - ``local_select_bool`` / ``local_data_select`` (one expert),
    ``build_kdtrees`` and ``get_where_list_legacy``

Tables are a DataFrame or any mapping of column name -> array (a DataFrame
is one), so the sweep needs no pandas. The radius query of a 2-column
entry runs on the host library's grid-hash index
(``native.radius_query_all``, ``index="grid"``, the default, as in the JAX
package) or on scipy's ``cKDTree`` (``index="kdtree"``, the plain
version); both give the same sorted sets. An entry of another number of
columns takes the kdtree.

The reference is split on the boundary rule, and both rules are kept
exactly: local selection is inclusive (d <= r, scipy's ball query, even for
comp "<"), prediction locations are strict (d < max_dist). Binned data sits
at exact multiples of the bin width from on-grid experts, so points on the
boundary are the normal case, not a corner case.
"""

from __future__ import annotations

import operator
import warnings
from functools import reduce
from typing import List, Optional

import numpy as np

from gpsat_tpu_torch import native
from gpsat_tpu_torch.utils.config_func import config_func, eval_namespace
from gpsat_tpu_torch.utils.misc import pandas_to_dict

_OPS = {
    ">=": operator.ge,
    ">": operator.gt,
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
}


def _compare(x, comp: str, val):
    assert comp in _OPS, f"comp: {comp} is not valid; use one of {list(_OPS)}"
    return _OPS[comp](x, val)


def num_rows(table) -> int:
    """Rows of a DataFrame or of a mapping of equal-length columns."""
    if hasattr(table, "index"):
        return len(table.index)
    return len(np.asarray(next(iter(table.values())))) if len(table) else 0


def column_names(table) -> list:
    return list(table.columns) if hasattr(table, "columns") else list(table.keys())


def columns_array(table, cols, dtype=float) -> np.ndarray:
    """[rows, len(cols)] array of the named columns."""
    return np.stack([np.asarray(table[c], dtype=dtype) for c in cols], axis=1)


def bool_array_from_where(df, wd: dict) -> np.ndarray:
    """One where-dict -> boolean array over the table's rows."""
    simple = all(k in wd for k in ("col", "comp", "val"))
    wd = wd.copy()
    negate = wd.pop("negate", False)
    if simple:
        col, comp, val = wd["col"], wd["comp"], wd["val"]
        assert col in column_names(df), f"col: '{col}' is not in columns: {column_names(df)}"
        x = np.asarray(df[col])
        if np.issubdtype(x.dtype, np.datetime64) and isinstance(val, str):
            val = np.datetime64(val)
        out = _compare(x, comp, val)
    else:
        out = config_func(df=df, **wd)
    out = np.asarray(out)
    return ~out if negate else out


def row_select_bool(df, row_select=None, combine: str = "AND", **kwargs):
    """Combine where-dicts into one row mask (True everywhere if empty)."""
    if row_select is None:
        row_select = []
    elif isinstance(row_select, dict):
        row_select = [row_select]
    assert isinstance(row_select, list), f"row_select must be list of dict, got: {type(row_select)}"
    for i, rs in enumerate(row_select):
        assert isinstance(rs, dict), f"row_select[{i}] is {type(rs)}, not dict"
    combine = combine.upper()
    assert combine in ("AND", "OR"), f"combine: {combine} not in ['AND','OR']"

    masks = [bool_array_from_where(df, wd) for wd in row_select]
    if not masks:
        return np.ones(num_rows(df), dtype=bool)
    op = (lambda a, b: a & b) if combine == "AND" else (lambda a, b: a | b)
    return np.asarray(reduce(op, masks))


def data_select(df, where=None, combine: str = "AND", copy: bool = True):
    """Filter a DataFrame with the where DSL."""
    if where is None:
        return df.copy() if copy else df
    if isinstance(where, dict):
        where = [where]
    out = df.loc[row_select_bool(df, where, combine=combine)]
    return out.copy() if copy else out


def radius_query_all(coords: np.ndarray, refs: np.ndarray, radius: float, *, inclusive: bool = True,
                     index: str = "grid") -> List[np.ndarray]:
    """Per-reference sorted index arrays of the points within ``radius``.

    ``inclusive`` selects the boundary rule: True = d <= r (scipy's
    ``query_ball_point``, the local-select convention, ref:
    dataloader.py:2437-2440); False = d < r (the ``_max_dist_bool``
    prediction-location convention, ref: prediction_locations.py:18-43).
    ``index`` "grid" runs 2-d points on the host library's grid-hash index,
    "kdtree" on scipy's ``cKDTree``; points of another dimension always
    take the kdtree.
    """
    native.check_index(index)
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    refs = np.ascontiguousarray(np.atleast_2d(refs), dtype=np.float64)
    if coords.shape[1] != 2:
        index = "kdtree"
    return native.radius_query_all(coords, refs, radius, inclusive=inclusive, index=index)


def build_kdtrees(df, local_select: List[dict]):
    """One cKDTree per multi-column local_select entry, None for the others
    (ref: dataloader.py:2293-2350)."""
    from scipy.spatial import cKDTree

    out = []
    for ls in local_select:
        col = ls["col"]
        if isinstance(col, str):
            out.append(None)
        else:
            assert ls["comp"] in ("<", "<="), "multi-column select requires a less-than comparison"
            out.append(cKDTree(columns_array(df, list(col))))
    return out


def local_select_bool(df, reference_location, local_select: List[dict], kdtree=None) -> np.ndarray:
    """Boolean mask of the rows within one expert's local window.

    Single-column entries compare ``df[col] <comp> ref[col] + val`` (e.g.
    t within +-4 days); multi-column entries keep the euclidean ball of
    radius val around the expert (inclusive, scipy's ball query), through
    ``kdtree`` (one tree, or ``build_kdtrees``'s list) when given.
    """
    from scipy.spatial import cKDTree

    select = np.ones(num_rows(df), dtype=bool)
    ref = pandas_to_dict(reference_location)
    cols = column_names(df)
    for idx, ls in enumerate(local_select):
        col, comp = ls["col"], ls["comp"]
        if isinstance(col, str):
            assert col in cols, f"col: {col} not in data columns: {cols}"
            assert col in ref, f"col: {col} not in reference location: {list(ref)}"
            select &= np.asarray(_compare(np.asarray(df[col]), comp, ref[col] + ls["val"]))
        else:
            assert comp in ("<", "<="), "multi-column select requires a less-than comparison"
            for c in col:
                assert c in cols, f"column: {c} not in data columns"
                assert c in ref, f"column: {c} not in reference location"
            kdt = None
            if kdtree is not None:
                kdt = kdtree[idx] if isinstance(kdtree, list) else kdtree
            if kdt is None:
                kdt = cKDTree(columns_array(df, list(col)))
            in_ids = kdt.query_ball_point(x=[ref[c] for c in col], r=ls["val"])
            m = np.zeros(num_rows(df), dtype=bool)
            m[in_ids] = True
            select &= m
    return select


def local_data_select(df, reference_location, local_select, kdtree=None, verbose: bool = False):
    """The rows of a DataFrame within one expert's local window."""
    return df.loc[local_select_bool(df, reference_location, local_select, kdtree=kdtree), :]


def local_select_indices_all(df, ref_locs, local_select: List[dict], *, index: str = "grid") -> List[np.ndarray]:
    """Per-expert sorted row-index arrays of the local window, all experts
    in one pass (ref: GPSat/dataloader.py:2354-2447 runs one KDTree query
    per expert).

    ``df`` and ``ref_locs`` are DataFrames or mappings of column -> array.
    The first multi-column entry is one radius query for all experts
    (inclusive d <= r, on ``index``: "grid" or "kdtree", the same sets);
    the remaining entries filter each expert's candidates: scalar ones
    compare ``df[col] <comp> ref[col] + val``, further multi-column ones
    keep d^2 <= r^2. Equal, expert by expert, to
    ``np.flatnonzero(local_select_bool(...))``.
    """
    E = num_rows(ref_locs)
    n = num_rows(df)
    multi = [ls for ls in local_select if not isinstance(ls["col"], str)]
    scalar = [ls for ls in local_select if isinstance(ls["col"], str)]
    for ls in multi:
        assert ls["comp"] in ("<", "<="), "multi-column select requires a less-than comparison"

    if multi:
        ls0 = multi[0]
        cols = list(ls0["col"])
        cand = radius_query_all(columns_array(df, cols), columns_array(ref_locs, cols), float(ls0["val"]),
                                index=index)
        multi_rest = multi[1:]
    else:
        cand = [np.arange(n, dtype=np.int64)] * E
        multi_rest = []

    scalar_vals = {ls["col"]: np.asarray(df[ls["col"]]) for ls in scalar}
    rest_vals = {tuple(ls["col"]): columns_array(df, ls["col"]) for ls in multi_rest}
    ref_cols = {c: np.asarray(ref_locs[c]) for c in column_names(ref_locs)}

    out = []
    for e in range(E):
        ix = np.sort(np.asarray(cand[e], dtype=np.int64))
        for ls in scalar:
            keep = np.asarray(_compare(scalar_vals[ls["col"]][ix], ls["comp"], ref_cols[ls["col"]][e] + ls["val"]))
            ix = ix[keep]
        for ls in multi_rest:
            p = rest_vals[tuple(ls["col"])][ix]
            refp = np.asarray([ref_cols[c][e] for c in ls["col"]], dtype=float)
            d2 = np.sum((p - refp) ** 2, axis=1)
            ix = ix[d2 <= float(ls["val"]) ** 2]
        out.append(ix)
    return out


def get_where_list(global_select, local_select=None, ref_loc=None) -> List[dict]:
    """Static + dynamic global selects -> concrete where-dict list.

    Dynamic entries {loc_col, src_col, func} evaluate
    func(ref[loc_col], ls["val"]) for each local_select entry on loc_col,
    producing a pushdown condition on src_col.
    """
    out = []
    ref = pandas_to_dict(ref_loc) if ref_loc is not None else None
    for gs in global_select:
        if all(c in gs for c in ("col", "comp", "val")):
            out.append(gs)
        else:
            assert local_select is not None, f"dynamic where {gs} requires local_select"
            assert ref is not None, f"dynamic where {gs} requires ref_loc"
            assert all(c in gs for c in ("loc_col", "src_col", "func")), (
                f"dynamic where keys: {list(gs)}, must have ['loc_col', 'src_col', 'func']"
            )
            loc_col = gs["loc_col"]
            assert loc_col in ref, f"loc_col: {loc_col} not in ref_loc: {ref}"
            func = gs["func"]
            if isinstance(func, str):
                func = eval(func, eval_namespace())  # noqa: S307 — reference-compat executable config
            for ls in local_select:
                if loc_col == ls["col"]:
                    out.append({"col": gs["src_col"], "comp": ls["comp"], "val": func(ref[loc_col], ls["val"])})
    return out


def get_where_list_legacy(read_in_by: Optional[dict] = None, where=None):
    """Expand a ``read_in_by`` spec into a list of HDF-style where-string
    lists (ref: GPSat/dataloader.py get_where_list_legacy). Each key maps to
    {"values": ..., "how": ...}; "interval" makes [>=, <) pairs from
    consecutive values, any other ``how`` is used as a comparison operator.
    ``values`` may be {"func": ..., **kwargs}, resolved through
    ``config_func``."""
    import re

    if read_in_by is None:
        where_list = where
        if not isinstance(where_list, list):
            where_list = [where_list]
        return where_list

    assert isinstance(read_in_by, dict), (
        f"read_in_by provided, expected to be dict, got: {type(read_in_by)}"
    )
    if where is not None:
        warnings.warn("'read_in_by' is specified, as is 'where' in 'input' of config, will ignore 'where'")

    where_dict = {}
    for k, v in read_in_by.items():
        vals = v["values"]
        how = v["how"]
        if isinstance(vals, dict):
            vals = dict(vals)
            func = vals.pop("func")
            vals = config_func(func, kwargs=vals)
        if isinstance(vals, (int, float, str)):
            vals = [vals]
        if not isinstance(vals, np.ndarray):
            vals = np.array(vals)
        numeric = bool(re.search("int|float", str(vals.dtype)))
        q = "" if numeric else "'"
        if how == "interval":
            w = [[f"{k} >= {q}{vals[i]}{q}", f"{k} < {q}{vals[i + 1]}{q}"]
                 for i in range(len(vals) - 1)]
        else:
            w = [[f"{k} {how} {q}{val}{q}"] for val in vals]
        where_dict[k] = w

    return reduce(lambda x, y: [xi + yi for xi in x for yi in y], where_dict.values())
