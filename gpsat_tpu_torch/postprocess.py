"""Post-processing: hyperparameter-field smoothing and prediction gluing.

Port of ``gpsat_tpu/postprocess.py`` (ref: GPSat/postprocessing.py):

- ``gaussian_2d_weight``: the NaN-aware Gaussian-kernel weighted mean of a
  field onto target points, as one [n_t, n_s] torch computation on a device
  (the card unless ``device="cpu"``), in f64.
- ``smooth_table`` / ``smooth_hyperparameters``: read the per-expert
  hyperparameter tables of a results store, clip and smooth each (x, y)
  field per slice of the other dimensions, write ``<param><suffix>_SMOOTHED``
  tables (and copies of the unsmoothed params) with their ``smooth_config``
  attributes, and emit a predict-only OI config (``optimise=False``,
  ``load_params`` pointing at the smoothed tables).
- ``glue_local_predictions_1d/2d``: normalised Gaussian-weighted averages of
  overlapping expert predictions, sigma = inference_radius / R (pandas and
  scipy on the host).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.experts import get_results_from_h5file
from gpsat_tpu_torch.models import get_model, stored_param_names
from gpsat_tpu_torch.parallel.engine import resolve_device
from gpsat_tpu_torch.utils.misc import cprint, json_serializable


def gaussian_2d_weight(x0, y0, x, y, l_x, l_y, vals, device=None) -> np.ndarray:
    """NaN-aware Gaussian-kernel weighted mean onto target points.

    out[i] = sum_j w_ij vals_j / sum_j w_ij over non-NaN vals_j, with
    w_ij = exp(-(((x_j-x0_i)/l_x)^2 + ((y_j-y0_i)/l_y)^2)/2); NaN where all
    weights vanish. Computed in f64 on ``device`` (default: the CUDA device,
    which must exist; ``device="cpu"`` for the CPU); returns a numpy array.
    """
    dev = resolve_device(device)
    x0, y0, x, y, vals = (torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev) for a in (x0, y0, x, y, vals))
    d2 = ((x[None, :] - x0[:, None]) / l_x) ** 2 + ((y[None, :] - y0[:, None]) / l_y) ** 2
    ok = torch.isfinite(vals)
    w = torch.exp(-d2 / 2.0) * ok[None, :]
    w_sum = w.sum(dim=1)
    w_val = (w * torch.where(ok, vals, torch.zeros_like(vals))[None, :]).sum(dim=1)
    empty = w_sum == 0.0
    out = torch.where(empty, torch.full_like(w_sum, float("nan")), w_val / torch.where(empty, torch.ones_like(w_sum), w_sum))
    return out.cpu().numpy()


@dataclasses.dataclass
class SmoothingConfig:
    """Per-parameter smoothing spec (ref: postprocessing.py:55-93)."""

    l_x: Union[int, float] = 1
    l_y: Union[int, float] = 1
    max: Union[int, float, None] = None
    min: Union[int, float, None] = None

    def __getitem__(self, item):
        if hasattr(self, item):
            return getattr(self, item)
        raise AttributeError(f"{item} is not an attribute of {type(self)}")

    def get(self, key, default=None):
        return self[key] if hasattr(self, key) else default


def smooth_table(df, val_col: str, coords_col: List[str], xy_dims: List[str], smooth_config, device=None):
    """One parameter table smoothed over ``xy_dims``: the values clipped to
    [min, max], then ``gaussian_2d_weight`` of the field onto its own points,
    once per combination of the other coordinates and ``_dim_*`` columns.
    Rows whose smoothed value is NaN are dropped. Returns a new DataFrame
    with ``df``'s columns, indexed by ``coords_col``."""
    import pandas as pd

    x_col, y_col = xy_dims
    df_org_cols = df.columns.values.tolist()
    other_dims = [c for c in coords_col if c not in xy_dims]
    other_dims += [c for c in df.columns if re.search(r"^_dim_\d", c)]
    smooth_list = []
    for _, row in df[other_dims].drop_duplicates().iterrows():
        row_df = row.to_frame().T.merge(df, on=other_dims, how="inner")
        x0 = row_df[x_col].values.astype(float)
        y0 = row_df[y_col].values.astype(float)
        vals = row_df[val_col].values.astype(float)
        if smooth_config.get("max") is not None:
            vals = np.minimum(vals, smooth_config["max"])
        if smooth_config.get("min") is not None:
            vals = np.maximum(vals, smooth_config["min"])
        tmp = row_df[[val_col, x_col, y_col]].copy()
        tmp[val_col] = gaussian_2d_weight(x0, y0, x0, y0, smooth_config["l_x"], smooth_config["l_y"], vals,
                                          device=device)
        tmp = tmp.dropna()
        for od in other_dims:
            tmp[od] = row[od]
        smooth_list.append(tmp[df_org_cols])
    return pd.concat(smooth_list).set_index(coords_col)


def smooth_hyperparameters(
    result_file: str,
    params_to_smooth: List[str],
    smooth_config_dict: Dict[str, Union[SmoothingConfig, dict]],
    xy_dims: List[str] = ["x", "y"],
    reference_table_suffix: str = "",
    table_suffix: str = "_SMOOTHED",
    output_file: Optional[str] = None,
    model_name: Optional[str] = None,
    save_config_file: bool = True,
    device=None,
):
    """Smooth per-expert hyperparameter fields; write *_SMOOTHED tables and
    (optionally) a predict-only config JSON. Returns the config path.
    ``device`` is where ``gaussian_2d_weight`` runs (default: the card)."""
    assert table_suffix != reference_table_suffix
    assert len(xy_dims) == 2, "dimensions to smooth over must have length 2"

    smooth_config_dict = {
        k: (v if isinstance(v, SmoothingConfig) else SmoothingConfig(**v)) for k, v in smooth_config_dict.items()
    }

    # model name -> param_names (ref: :183-216)
    if model_name is None:
        with TableStore(result_file, mode="r") as store:
            run_details = store.select(f"run_details{reference_table_suffix}")
        unique_models = run_details["model"].unique()
        assert len(unique_models) == 1, (
            f"more than one model found in run_details{reference_table_suffix}: {unique_models}"
        )
        model_name = str(unique_models[-1]).split(".")[-1]
        print(f"found model_name: {model_name}")

    all_params = stored_param_names(get_model(model_name))
    assert all(p in all_params for p in params_to_smooth), (
        f"some params_to_smooth {params_to_smooth} not in model.param_names {all_params}"
    )
    other_params = [p for p in all_params if p not in params_to_smooth]

    smooth_with_suffix = [f"{p}{reference_table_suffix}" for p in params_to_smooth]
    other_with_suffix = [f"{p}{reference_table_suffix}" for p in other_params]
    smooth_config_dict = {f"{k}{reference_table_suffix}": v for k, v in smooth_config_dict.items()}

    dfs, oi_configs = get_results_from_h5file(
        result_file,
        merge_on_expert_locations=False,
        select_tables=all_params,
        table_suffix=reference_table_suffix,
        add_suffix_to_table=True,
    )
    coords_col = oi_configs[-1]["data"]["coords_col"]

    out = {}
    for hp_idx, hp in enumerate(smooth_with_suffix):
        assert hp in smooth_config_dict, f"parameter table {hp} has no smoothing config"
        assert hp in dfs, f"parameter table {hp} not found in {list(dfs)}"
        out_table = f"{hp}{table_suffix}"
        cprint(f"adding smoothed table: {out_table}", c="OKCYAN")
        out[out_table] = smooth_table(dfs[hp].copy(), params_to_smooth[hp_idx], coords_col, xy_dims,
                                      smooth_config_dict[hp], device=device)
        smooth_config_dict[out_table] = smooth_config_dict[hp]

    for param in other_with_suffix:
        out_table = f"{param}{table_suffix}"
        if param in dfs:
            cprint(f"copying table: {param} to {out_table}", c="OKCYAN")
            out[out_table] = dfs[param].copy().set_index(coords_col)
        else:
            cprint(f"{param} not found, skipping", c="FAIL")

    output_file = result_file if output_file is None else output_file
    with TableStore(output_file) as store:
        for k, v in out.items():
            store.put(k, v, replace=True)
            sc = smooth_config_dict.get(k)
            store.put_attrs(
                k,
                smooth_config=(
                    dataclasses.asdict(sc)
                    if sc is not None
                    else {"comment": f"no smoothing, copied directly from {re.sub(f'{table_suffix}$', '', k)}"}
                ),
            )

    if save_config_file:
        out_config = re.sub(r"\.h5$", f"{reference_table_suffix}{table_suffix}.json", result_file)
        tmp = []
        for oic in oi_configs:
            run_kwargs = oic.get("run_kwargs", {})
            run_kwargs["optimise"] = False
            run_kwargs["table_suffix"] = f"{reference_table_suffix}{table_suffix}"
            run_kwargs["store_path"] = output_file
            model = oic["model"]
            model["load_params"] = {"file": output_file, "table_suffix": f"{reference_table_suffix}{table_suffix}"}
            oic["run_kwargs"] = run_kwargs
            oic["model"] = model
            tmp.append(json_serializable(oic))
        cprint(f"writing predict-only config to:\n{out_config}", c="OKBLUE")
        with open(out_config, "w") as f:
            json.dump(tmp, f, indent=4)
        return out_config


# --------------------------------------------------------------------------
# prediction gluing (ref: postprocessing.py:447-577)
# --------------------------------------------------------------------------


def glue_local_predictions_1d(
    preds_df,
    pred_loc_col: str,
    xprt_loc_col: str,
    vars_to_glue: Union[str, List[str]],
    inference_radius: Union[int, float, dict],
    R: float = 3,
):
    """Gaussian-weighted average of overlapping 1-d expert predictions."""
    from scipy.stats import norm

    if isinstance(vars_to_glue, str):
        vars_to_glue = [vars_to_glue]
    preds = preds_df.copy(deep=True)

    if isinstance(inference_radius, dict):
        assert len(inference_radius) == len(preds[xprt_loc_col].unique())
        inference_radius = np.array([inference_radius[loc] for loc in preds[xprt_loc_col]])

    preds["weights"] = norm.pdf(preds[pred_loc_col], preds[xprt_loc_col], inference_radius / R)
    preds["total_weights"] = preds["weights"]
    for var in vars_to_glue:
        preds[var] = preds[var] * preds["weights"]
    glued = preds[[pred_loc_col, "total_weights"] + vars_to_glue].groupby([pred_loc_col]).sum().reset_index()
    for var in vars_to_glue:
        glued[var] = glued[var] / glued["total_weights"]
    return glued.drop("total_weights", axis=1)


def glue_local_predictions_2d(
    preds_df,
    pred_loc_cols: List[str],
    xprt_loc_cols: List[str],
    vars_to_glue: Union[str, List[str]],
    inference_radius: Union[int, float],
    R: float = 3,
):
    """Gaussian-weighted average of overlapping 2-d expert predictions
    (separable per-axis normal weights, as the reference's)."""
    from scipy.stats import norm

    if isinstance(vars_to_glue, str):
        vars_to_glue = [vars_to_glue]
    preds = preds_df.copy(deep=True)

    preds["total_weights"] = 1.0
    for pred_col, xprt_col in zip(pred_loc_cols, xprt_loc_cols):
        preds["total_weights"] = preds["total_weights"] * norm.pdf(preds[pred_col], preds[xprt_col], inference_radius / R)
    for var in vars_to_glue:
        preds[var] = preds[var] * preds["total_weights"]
    glued = preds[pred_loc_cols + ["total_weights"] + vars_to_glue].groupby(pred_loc_cols).sum().reset_index()
    for var in vars_to_glue:
        glued[var] = glued[var] / glued["total_weights"]
    return glued.drop("total_weights", axis=1)


def glue_local_predictions(
    preds_df,
    inference_radius: Union[int, float],
    R: float = 3,
    pred_loc_cols: List[str] = ["pred_loc_x", "pred_loc_y"],
    xprt_loc_cols: List[str] = ["x", "y"],
    vars_to_glue: Optional[List[str]] = None,
):
    """``glue_local_predictions_2d`` with the preds table's column names.

    ``f*`` is the de-meaned posterior, the subtracted per-expert mean stored
    as ``f_bar``; ``f_bar`` is glued too when present, so callers can
    rebuild the field as ``f* + f_bar``.
    """
    if vars_to_glue is None:
        vars_to_glue = ["f*", "f*_var", "y_var"]
        if "f_bar" in preds_df.columns:
            vars_to_glue.append("f_bar")
    return glue_local_predictions_2d(preds_df, pred_loc_cols, xprt_loc_cols, vars_to_glue, inference_radius, R)
