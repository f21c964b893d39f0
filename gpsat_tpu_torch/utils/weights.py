"""Distance-weighted combination of overlapping expert predictions.

The port's own copy of ``gpsat_tpu/utils/weights.py``.

``get_weighted_values`` matches the behavior of the reference's
pivot-table-based Gaussian weighting (ref: GPSat/utils.py:2081-2214) but is
implemented as a flat segment reduction: unique reference locations are
factorized to integer segment ids once, and every weighted sum is a single
``np.bincount`` over those ids — one pass per value column instead of one
pivot-table build per value column.

The weight is exp(-d^2 / (2 l^2)) on the squared euclidean distance between
``ref_col`` (prediction location) and ``dist_to_col`` (expert location),
normalized per unique reference location. Rows whose value is NaN contribute
to the normalizing weight sum but not to the weighted value sum (the
reference's skipna-sum semantics).
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import pandas as pd


def _as_list(x) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def get_weighted_values(
    df: pd.DataFrame,
    ref_col: Union[str, List[str]],
    dist_to_col: Union[str, List[str]],
    val_cols: Union[str, List[str]],
    weight_function: str = "gaussian",
    drop_weight_cols: bool = True,
    **weight_kwargs,
) -> pd.DataFrame:
    ref_col = _as_list(ref_col)
    dist_to_col = _as_list(dist_to_col)
    val_cols = _as_list(val_cols)

    ref_pts = df[ref_col].to_numpy()
    xprt_pts = df[dist_to_col].to_numpy()
    if ref_pts.shape != xprt_pts.shape:
        raise ValueError(
            f"ref_col shape {ref_pts.shape} != dist_to_col shape {xprt_pts.shape}"
        )

    if weight_function != "gaussian":
        raise NotImplementedError(f"weight_function: {weight_function} is not implemented")
    lengthscale = weight_kwargs.get("lengthscale", None)
    assert lengthscale is not None, "lengthscale is None, please provide"
    diff = ref_pts - xprt_pts
    sq_dist = np.einsum("ij,ij->i", diff, diff)
    w = np.exp(-0.5 * sq_dist / float(lengthscale) ** 2)

    # segment ids: one per unique reference location, sorted so output
    # ordering matches the reference's (sorted) pivot-table index.
    # NaN-containing keys are dropped up front (pivot_table's dropna
    # semantics — MultiIndex.factorize does NOT mark them -1)
    valid = (~df[ref_col].isna().any(axis=1)).to_numpy()
    keys = pd.MultiIndex.from_arrays(
        [df[c].to_numpy()[valid] for c in ref_col], names=ref_col
    )
    seg_v, uniques = keys.factorize(sort=True)
    w_v = w[valid]
    n_seg = len(uniques)

    out = pd.DataFrame({c: uniques.get_level_values(i) for i, c in enumerate(ref_col)})
    w_sum = np.bincount(seg_v, weights=w_v, minlength=n_seg)
    if not drop_weight_cols:
        out["_w"] = w_sum
    for vc in val_cols:
        v = df[vc].to_numpy(dtype=float)[valid]
        wv_sum = np.bincount(
            seg_v, weights=np.where(np.isnan(v), 0.0, w_v * np.nan_to_num(v)), minlength=n_seg
        )
        if not drop_weight_cols:
            out[f"w_{vc}"] = wv_sum
        out[vc] = wv_sum / w_sum
    return out
