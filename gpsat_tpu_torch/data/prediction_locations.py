"""Per-expert prediction-location generation.

The port's own copy of ``gpsat_tpu/data/prediction_locations.py``
(ref: GPSat/prediction_locations.py:50-281), with the methods
  - 'expert_loc'     — predict at the expert location only
  - 'shift_arrays'   — meshgrid of offsets around the expert (:182-205)
  - 'from_dataframe' — fixed fine grid filtered to a max_dist radius (:208-273)
  - 'from_source'    — loaded once, then 'from_dataframe' (:82-100)
and ``batch_call`` for many experts at once, with the same row order.

The grid (``df``) and the expert rows are DataFrames or mappings of column
-> array, so ``batch_call`` needs no pandas. The radius rule is strict
(d < max_dist), the reference's ``_max_dist_bool`` convention.

``index`` picks the arm of the radius filter: "grid" (the default, as in
the JAX package) runs the host library's ``max_dist_bool`` and grid-hash
radius query (``gpsat_tpu_torch/native.py``), "kdtree" the plain versions:
the numpy mask ``max_dist_bool`` below and scipy's ``cKDTree``. Both give
the same rows in the same order on f64 coordinates (the host library
compares in f64, the numpy mask in the grid's dtype).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gpsat_tpu_torch import native
from gpsat_tpu_torch.data import select as sel
from gpsat_tpu_torch.utils.misc import loaded_pandas, to_array


def max_dist_bool(locs: np.ndarray, ref_loc: np.ndarray, max_dist: float, chunk: int = 4_000_000) -> np.ndarray:
    """Strict euclidean-ball mask ||loc - ref|| < max_dist over [n, d] rows.

    Per-dimension |d| < r prefilter narrows candidates before the full
    norm, processed in chunks to bound peak memory at ~chunk doubles.
    """
    locs = np.ascontiguousarray(locs)
    ref = np.asarray(ref_loc).reshape(-1)
    n = locs.shape[0]
    out = np.zeros(n, dtype=bool)
    r2 = float(max_dist) ** 2
    for s in range(0, n, chunk):
        blk = locs[s : s + chunk]
        cand = np.abs(blk[:, 0] - ref[0]) < max_dist
        for j in range(1, blk.shape[1]):
            cand &= np.abs(blk[:, j] - ref[j]) < max_dist
        if cand.any():
            sub = blk[cand] - ref
            cand[cand] = np.einsum("ij,ij->i", sub, sub) < r2
        out[s : s + chunk] = cand
    return out


def _match(x, y):
    """Index positions of x's entries in list y."""
    xs = [x] if isinstance(x, str) else list(x)
    return np.array([list(y).index(v) for v in xs])


class PredictionLocations:
    def __init__(self, method: str = "expert_loc", coords_col=None, expert_loc=None, index: str = "grid", **kwargs):
        self.method = method
        self.index = native.check_index(index)
        self.kwargs = kwargs
        self._coords_col = None
        self.coords_col = coords_col
        self._expert_loc = None
        self.expert_loc = expert_loc

    # --- properties ---
    @property
    def coords_col(self):
        return self._coords_col

    @coords_col.setter
    def coords_col(self, value):
        if value is None:
            self._coords_col = None
        elif isinstance(value, np.ndarray):
            assert value.ndim == 1
            self._coords_col = value.tolist()
        elif isinstance(value, list):
            self._coords_col = value
        else:
            raise ValueError(f"coords_col type not handled: {type(value)}")

    @staticmethod
    def _1row_2d_array(x):
        if isinstance(x, list):
            x = np.array(x)
        assert isinstance(x, np.ndarray)
        if x.ndim == 1:
            x = x[None, :]
        assert x.ndim == 2 and x.shape[0] == 1, f"expert_loc must be a single row, got shape {x.shape}"
        return x

    @property
    def expert_loc(self):
        return self._expert_loc

    @expert_loc.setter
    def expert_loc(self, value):
        pd = loaded_pandas()
        if value is None:
            self._expert_loc = None
        elif pd is not None and isinstance(value, (pd.DataFrame, pd.Series)):
            assert self.coords_col is not None, "coords_col must be set before assigning a DataFrame expert_loc"
            self._expert_loc = self._1row_2d_array(value[self.coords_col].values)
        elif isinstance(value, (np.ndarray, list)):
            self._expert_loc = self._1row_2d_array(value)
        else:
            raise ValueError(f"expert_loc type not handled: {type(value)}")

    # --- generation ---
    def __call__(self) -> np.ndarray:
        if self.method == "shift_arrays":
            out = self._shift_arrays(**self.kwargs)
        elif self.method == "expert_loc":
            out = self.expert_loc
        elif self.method == "from_dataframe":
            out = self._from_dataframe(**self.kwargs)
        elif self.method == "from_source":
            self._resolve_source()
            out = self._from_dataframe(**self.kwargs)
        else:
            raise ValueError(f"method: '{self.method}' not implemented")

        if (self.method == "from_dataframe") and ("local_select" in self.kwargs):
            cols = {c: out[:, i] for i, c in enumerate(self.coords_col)}
            ref = {c: self.expert_loc[0, i : i + 1] for i, c in enumerate(self.coords_col)}
            out = out[sel.local_select_indices_all(cols, ref, self.kwargs["local_select"], index=self.index)[0]]

        assert isinstance(out, np.ndarray), f"must return ndarray, got: {type(out)}"
        assert out.ndim == 2, f"must return 2d array, got {out.ndim}d"
        return out

    def batch_call(self, expert_rows, index: Optional[str] = None) -> list:
        """Per-expert prediction arrays for many experts in one pass.

        ``expert_rows`` is a DataFrame or a mapping of column -> array;
        ``index`` (default: the object's) picks the radius filter's arm. The
        'from_dataframe' + max_dist case (a fine fixed grid radius-filtered
        per expert) runs one radius query for all experts instead of a
        full-grid mask per expert; every other method and option takes the
        per-expert path with identical results. Row order matches the
        per-expert masks (grid order).
        """
        if self.method == "from_source":
            # resolve the lazy load up front so from_source + max_dist
            # configs take the batched path too
            self._resolve_source()
        if (self.method == "from_dataframe" and self.kwargs.get("df") is None and self.kwargs.get("df_file")
                and self.coords_col is not None):
            # likewise read a config's df_file once here: the per-expert
            # path masks the whole grid once per expert
            self.kwargs["df"] = self._grid_columns(None, self.kwargs["df_file"], self.kwargs.get("copy_df", False))
        md = self.kwargs.get("max_dist")
        df = self.kwargs.get("df")
        found_cols = (
            [c for c in self.coords_col if c in sel.column_names(df)]
            if df is not None and self.coords_col is not None else []
        )
        batchable = (
            self.method == "from_dataframe"
            and md is not None
            and df is not None
            and "local_select" not in self.kwargs
            and len(found_cols) == 2
            # non-f64 grids take the per-expert path: _from_dataframe casts
            # the expert loc to the grid dtype and masks in that dtype; the
            # batched query is f64-only, so only f64 is identical between them
            and all(np.asarray(df[c]).dtype == np.float64 for c in found_cols)
            and all(np.issubdtype(np.asarray(expert_rows[c]).dtype, np.number) for c in self.coords_col)
        )
        E = sel.num_rows(expert_rows)
        locs = np.stack([np.asarray(expert_rows[c]) for c in self.coords_col], axis=1)
        if not batchable:
            kept, self.index = self.index, native.check_index(index or self.index)
            try:
                out = []
                for i in range(E):
                    self.expert_loc = locs[i : i + 1]
                    out.append(self())
            finally:
                self.index = kept
            return out

        vals = sel.columns_array(df, found_cols)
        refs = locs.astype(float)
        fc_loc = _match(found_cols, self.coords_col)
        idx_sets = sel.radius_query_all(vals, refs[:, fc_loc], float(md), inclusive=False,
                                        index=native.check_index(index or self.index))
        out = []
        full_dims = len(found_cols) == len(self.coords_col)
        missing = [c for c in self.coords_col if c not in found_cols]
        mloc = _match(missing, self.coords_col) if missing else None
        for e, ix in enumerate(idx_sets):
            sub = vals[np.sort(np.asarray(ix, dtype=np.int64))]
            if full_dims:
                out.append(sub)
            else:
                full = np.full((len(sub), len(self.coords_col)), np.nan)
                full[:, fc_loc] = sub
                full[:, mloc] = refs[e, mloc]
                out.append(full)
        return out

    def _resolve_source(self):
        """Load the 'from_source' grid once and become 'from_dataframe'
        (the reference's lazy-then-cached idiom, ref:
        GPSat/prediction_locations.py:82-100)."""
        assert "load_kwargs" in self.kwargs, (
            "method='from_source' requires 'load_kwargs' (passed to gpsat_tpu_torch.data.dataloader.load)"
        )
        from gpsat_tpu_torch.data.dataloader import load

        load_kwargs = self.kwargs.pop("load_kwargs")
        self.kwargs["df"] = load(**load_kwargs).drop_duplicates()
        self.method = "from_dataframe"

    def _to_array(self, x):
        (out,) = to_array(x)
        return out

    def _shift_arrays(self, Xout=None, **kwargs):
        if Xout is None:
            xis = [self._to_array(kwargs.get(c, np.zeros(1))) for c in self.coords_col]
            for x in xis:
                assert x.ndim == 1
            Xis = np.meshgrid(*xis, indexing="ij")
            Xout = np.concatenate([X.flatten()[:, None] for X in Xis], axis=1)
            self.kwargs["Xout"] = Xout
        return Xout + self.expert_loc

    def _grid_columns(self, df, df_file, copy_df: bool) -> dict:
        """The grid's coordinate columns as a mapping, from ``df`` or read
        from the CSV file ``df_file``."""
        if df is None:
            assert isinstance(df_file, str), f"df is None; df_file expected str, got: {type(df_file)}"
            import pandas as pd

            df = pd.read_csv(df_file)
        found_cols = [c for c in self.coords_col if c in sel.column_names(df)]
        return {c: np.array(df[c]) if copy_df else np.asarray(df[c]) for c in found_cols}

    def _from_dataframe(self, df=None, df_file=None, max_dist: Optional[float] = None, copy_df: bool = False, **kwargs):
        # keep only the coordinate columns, as a mapping, for later calls
        df = self.kwargs["df"] = self._grid_columns(df, df_file, copy_df)
        found_cols = list(df)

        fc_loc = _match(found_cols, self.coords_col)
        vals = np.stack([df[c] for c in found_cols], axis=1)
        if max_dist is not None:
            if self.expert_loc.dtype != vals.dtype:
                self.expert_loc = self.expert_loc.astype(vals.dtype)
            # the host library compares in f64, as the JAX package's does
            mask = native.max_dist_bool if self.index == "grid" else max_dist_bool
            b = mask(vals, self.expert_loc[0, fc_loc], max_dist)
            vals = vals[b]

        if len(found_cols) == len(self.coords_col):
            return vals
        out = np.full((len(vals), len(self.coords_col)), np.nan)
        out[:, fc_loc] = vals
        missing = [c for c in self.coords_col if c not in found_cols]
        mloc = _match(missing, self.coords_col)
        out[:, mloc] = self.expert_loc[:, mloc]
        return out
