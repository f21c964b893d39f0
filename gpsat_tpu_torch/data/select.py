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

Tables are a DataFrame or any mapping of column name -> array (a DataFrame
is one), so the sweep needs no pandas. The radius query is the scipy arm of
the JAX package's ``native.radius_query_all``; its C++ grid-hash index is
not ported yet (ROADMAP.md Queue 1 item 9).

The reference is split on the boundary rule, and both rules are kept
exactly: local selection is inclusive (d <= r, scipy's ball query, even for
comp "<"), prediction locations are strict (d < max_dist). Binned data sits
at exact multiples of the bin width from on-grid experts, so points on the
boundary are the normal case, not a corner case.
"""

from __future__ import annotations

import operator
from functools import reduce
from typing import List

import numpy as np
from scipy.spatial import cKDTree

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


def radius_query_all(coords: np.ndarray, refs: np.ndarray, radius: float, *, inclusive: bool = True) -> List[np.ndarray]:
    """Per-reference index arrays of the points within ``radius``.

    ``inclusive`` selects the boundary rule: True = d <= r (scipy's
    ``query_ball_point``, the local-select convention, ref:
    dataloader.py:2437-2440); False = d < r (the ``_max_dist_bool``
    prediction-location convention, ref: prediction_locations.py:18-43).
    """
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    refs = np.ascontiguousarray(np.atleast_2d(refs), dtype=np.float64)
    tree = cKDTree(coords)
    out = []
    for e, ix in enumerate(tree.query_ball_point(refs, radius)):
        ix = np.asarray(ix, dtype=np.int64)
        if not inclusive and len(ix):
            d2 = ((coords[ix] - refs[e]) ** 2).sum(axis=1)
            ix = ix[d2 < radius * radius]
        out.append(ix)
    return out


def local_select_indices_all(df, ref_locs, local_select: List[dict]) -> List[np.ndarray]:
    """Per-expert sorted row-index arrays of the local window, all experts
    in one pass (ref: GPSat/dataloader.py:2354-2447 runs one KDTree query
    per expert).

    ``df`` and ``ref_locs`` are DataFrames or mappings of column -> array.
    The first multi-column entry is one radius query for all experts
    (inclusive d <= r); the remaining entries filter each expert's
    candidates: scalar ones compare ``df[col] <comp> ref[col] + val``,
    further multi-column ones keep d^2 <= r^2.
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
        cand = radius_query_all(columns_array(df, cols), columns_array(ref_locs, cols), float(ls0["val"]))
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
