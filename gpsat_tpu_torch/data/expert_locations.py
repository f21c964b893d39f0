"""Expert-location generation + masks (ref: GPSat/dataloader.py:2610-2805,
GPSat/utils.py:1075 sparse_true_array).

The port's own copy of ``gpsat_tpu/data/expert_locations.py``.

The reference builds expert grids as xarray DataArrays with boolean masks;
xarray is not in this image, so the native representation is a DataFrame
over the product of location dimensions with an ``include`` column that
masks AND into — same semantics, tabular form.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import pandas as pd

from gpsat_tpu_torch.data import select as sel
from gpsat_tpu_torch.data.dataloader import add_cols


def sparse_true_array(shape, grid_space: int = 1, grid_space_offset: int = 0) -> np.ndarray:
    """Boolean array True at every grid_space-th index along each axis
    (ref: utils.py:1075)."""
    bools = []
    for n in shape:
        b = np.zeros(n, dtype=bool)
        b[grid_space_offset::grid_space] = True
        bools.append(b)
    out = bools[0]
    for b in bools[1:]:
        out = np.logical_and.outer(out, b)
    return out


def get_masks_for_expert_loc(ref_data: pd.DataFrame, el_masks=None, obs_col: Optional[str] = None, dims: Optional[List[str]] = None):
    """Build expert-location masks from binned reference data.

    ref_data: long DataFrame of binned obs (e.g. x, y, date, <obs_col>).
    el_masks entries:
      - "had_obs": keep grid cells with any non-NaN obs across the
        non-dim columns (ref: dataloader.py:2783-2790)
      - {"grid_space": k, "dims": [...]}: keep every k-th unique value of
        each dim (coarse regular mask, ref: :2792-2802)

    Returns a list of DataFrames with the dim columns + bool "include".
    """
    el_masks = el_masks or []
    el_masks = el_masks if isinstance(el_masks, list) else [el_masks]
    masks = []
    for m in el_masks:
        if isinstance(m, str):
            if m == "had_obs":
                assert obs_col is not None and dims is not None, "had_obs mask needs obs_col and dims"
                grp = ref_data.groupby(dims)[obs_col].apply(lambda s: bool(np.any(~pd.isna(s)))).reset_index()
                grp = grp.rename(columns={obs_col: "include"})
                masks.append(grp)
            else:
                warnings.warn(f"mask: {m} not understood")
        elif isinstance(m, dict) and "grid_space" in m:
            mdims = m["dims"]
            k = int(m["grid_space"])
            uniq = [np.sort(ref_data[d].unique()) for d in mdims]
            keep = [u[::k] for u in uniq]
            midx = pd.MultiIndex.from_product(keep, names=mdims)
            dfm = pd.DataFrame(index=midx).reset_index()
            dfm["include"] = True
            masks.append(dfm)
    return masks


def generate_local_expert_locations(
    loc_dims: dict,
    ref_data: Optional[pd.DataFrame] = None,
    masks=None,
    include_col: str = "include",
    col_func_dict: Optional[dict] = None,
    row_select: Optional[list] = None,
    keep_cols: Optional[list] = None,
    sort_by=None,
) -> pd.DataFrame:
    """Expert locations = product of loc_dims values, AND-filtered by masks.

    loc_dims values: arrays/lists of dim values, or a column name in
    ref_data (unique values used).
    """
    assert isinstance(loc_dims, dict), "loc_dims must be a dict"
    coord_dict = {}
    for k, v in loc_dims.items():
        if isinstance(v, str):
            assert ref_data is not None, f"loc_dim {k}='{v}' needs ref_data to resolve"
            assert v in ref_data.columns, f"{v} is not in ref_data columns"
            coord_dict[k] = np.sort(ref_data[v].unique())
        else:
            coord_dict[k] = np.asarray(v)

    midx = pd.MultiIndex.from_product(list(coord_dict.values()), names=list(coord_dict.keys()))
    locs = pd.DataFrame(True, index=midx, columns=[include_col]).reset_index()

    for m in masks or []:
        join_cols = [c for c in m.columns if c != include_col and c in locs.columns]
        mm = m.rename(columns={include_col: "_mask_include"})
        locs = locs.merge(mm[join_cols + ["_mask_include"]], on=join_cols, how="left")
        locs[include_col] &= locs["_mask_include"].astype("boolean").fillna(False).astype(bool)
        locs = locs.drop(columns="_mask_include")

    locs = locs.loc[locs[include_col]].drop(columns=include_col).reset_index(drop=True)

    add_cols(locs, col_func_dict)
    if row_select is not None:
        locs = locs.loc[sel.row_select_bool(locs, row_select)]
    if sort_by is not None:
        locs = locs.sort_values(sort_by)
    if keep_cols is not None:
        locs = locs.loc[:, keep_cols]
    return locs
