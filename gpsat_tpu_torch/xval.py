"""Cross-validation config expansion (ref: examples/create_xval_config.py).

The port's own copy of ``gpsat_tpu/xval.py``: host-only, no device.

Expands a reference OI config + an xval spec into a list of hold-out OI
configs: per held-out slice (e.g. per track, per date) the training data
gets a negated row_select excluding the slice, and the prediction
locations become the held-out points themselves
(ref: create_xval_config.py:43-300). Metrics for evaluating the held-out
predictions are in gpsat_tpu_torch.utils.misc (rmse, nll — ref:
utils.py:2452-2464); ``score_xval_predictions`` scores a mapping of
``preds_*`` frames (glue -> join -> RMSE/NLL), ``evaluate_xval_results``
reads them from a results store first (``TableStore``).

Usage: python -m gpsat_tpu_torch.cli xval <config.json> (or python -m
gpsat_tpu_torch.xval) with keys {ref_config | ref_config_file, xval_config
{pred_loc, wheres, func, col_args/col_kwargs, row_select_values,
output_file}, output_config_file, hold_out_data_is_pred_loc,
add_where_as_col_to_location, add_to_table_suffix}.
"""

from __future__ import annotations

import copy
import inspect
import json
import re
import sys
from typing import List, Mapping, Optional, Union

import numpy as np
import pandas as pd

from gpsat_tpu_torch.data import dataloader as DL
from gpsat_tpu_torch.utils.misc import cprint, get_config_from_sysargv, json_serializable

USAGE = ("usage: python -m gpsat_tpu_torch.cli xval <config.json>\n\n"
         "Expands a reference OI config into one hold-out OI config per held-out slice and writes them\n"
         "to output_config_file (default xval_configs.json). Config keys: ref_config | ref_config_file,\n"
         "xval_config {pred_loc, wheres, func, col_args / col_kwargs, row_select_values, output_file},\n"
         "output_config_file, hold_out_data_is_pred_loc, add_where_as_col_to_location, add_to_table_suffix.")


def return_as_list(x):
    return x if isinstance(x, list) else [x]


def remove_bad_table_char(x: str) -> str:
    return re.sub("-| |:|00:00:00", "", x)


class XvalConfig:
    def __init__(self, ref_config: dict = None, xval_config: dict = None):
        assert isinstance(ref_config, dict), f"reference config must be a dict, got: {type(ref_config)}"
        assert isinstance(xval_config, dict), f"xval config must be a dict, got: {type(xval_config)}"
        self.config = json_serializable({"ref_config": ref_config, "xval_config": xval_config})

        self.ref = copy.deepcopy(ref_config)
        self.ref.pop("pred_loc", None)
        self.data = copy.deepcopy(self.ref["data"])
        self.locations = copy.deepcopy(self.ref["locations"])
        self.model = copy.deepcopy(self.ref["model"])
        self.run_kwargs = copy.deepcopy(self.ref.get("run_kwargs", {}))
        self.comment = self.ref.get("comment", "")

        self.data["where"] = return_as_list(self.data.get("where") or [])
        self.data["row_select"] = return_as_list(self.data.get("row_select") or [])

        self.xval = copy.deepcopy(xval_config)
        self.output_file = self.xval.get("output_file", None)
        self.load_kwargs = self._get_load_kwargs_from_data(self.ref)

        assert "pred_loc" in self.xval, "xval config must contain pred_loc"
        self.pred_loc = self.xval["pred_loc"]
        self.hold_out_data_is_pred_loc = self.xval.get("hold_out_data_is_pred_loc", True)
        if self.hold_out_data_is_pred_loc:
            self.pred_loc["load_kwargs"] = self.load_kwargs

        col_select = list(self.xval.get("wheres", {}).keys()) + list(self.xval.get("row_select_values", []))
        self.col_select = list(dict.fromkeys(col_select))

    @staticmethod
    def _get_load_kwargs_from_data(ref):
        lk = copy.deepcopy(ref["data"])
        lk["source"] = lk.pop("data_source")
        valid = set(inspect.signature(DL.load).parameters)
        lk = {k: v for k, v in lk.items() if k in valid}
        lk["row_select"] = return_as_list(lk.get("row_select") or [])
        lk["where"] = return_as_list(lk.get("where") or [])
        return lk

    @staticmethod
    def _get_where_lists(wheres):
        if wheres is None:
            return [None]
        if isinstance(wheres, list):
            return wheres
        midx = pd.MultiIndex.from_product(list(wheres.values()), names=list(wheres.keys()))
        out = []
        for _, row in pd.DataFrame(index=midx).reset_index().iterrows():
            out.append([{"col": k, "comp": "==", "val": v} for k, v in row.to_dict().items()])
        return out

    @staticmethod
    def _format_row_value_dict(row: dict) -> dict:
        out = {}
        for k, v in row.items():
            if isinstance(v, pd.Timestamp):
                out[k] = str(np.datetime64(v).astype("datetime64[D]"))
            else:
                out[k] = v
        return out

    def get_xrs(self):
        """Per hold-out slice: (where, row_select, values)."""
        where_out, row_select_out, vals_out = [], [], []
        for w in self._get_where_lists(self.xval.get("wheres", None)):
            lkw = copy.deepcopy(self.load_kwargs)
            if w is not None:
                lkw["where"] = lkw["where"] + (w if isinstance(w, list) else [w])
            df = DL.load(**lkw)
            df = df[self.col_select].drop_duplicates()
            func = self.xval["func"]
            for _, row in df.iterrows():
                rs = {"func": func.format(**self._format_row_value_dict(row.to_dict()))}
                for key in ("col_args", "col_kwargs"):
                    if key in self.xval:
                        rs[key] = self.xval[key]
                row_select_out.append(rs)
                where_out.append(w)
                vals_out.append(row.to_dict())
        return where_out, row_select_out, vals_out

    def make_xval_oi_configs(
        self,
        hold_out_data_is_pred_loc: bool = True,
        add_where_as_col_to_location: bool = False,
        add_to_table_suffix: bool = True,
        verbose: bool = True,
    ) -> List[dict]:
        where_out, row_select_out, vals_out = self.get_xrs()
        oic = []
        for i in range(len(where_out)):
            w = where_out[i]
            xrs = copy.deepcopy(row_select_out[i])
            pl = copy.deepcopy(self.pred_loc)
            dc = copy.deepcopy(self.data)
            locs = copy.deepcopy(self.locations)
            m = copy.deepcopy(self.model)
            rkw = copy.deepcopy(self.run_kwargs)

            # exclude the hold-out slice from training data
            nxrs = copy.deepcopy(xrs)
            nxrs["negate"] = True
            dc["row_select"] = dc["row_select"] + [nxrs]

            if hold_out_data_is_pred_loc:
                assert pl["method"] == "from_source", (
                    "hold_out_data_is_pred_loc requires pred_loc method 'from_source'"
                )
                pl = copy.deepcopy(pl)
                pl["load_kwargs"] = copy.deepcopy(pl["load_kwargs"])
                if w is not None:
                    pl["load_kwargs"]["where"] = pl["load_kwargs"]["where"] + (
                        w if isinstance(w, list) else [w]
                    )
                pl["load_kwargs"]["row_select"] = pl["load_kwargs"]["row_select"] + [xrs]

            if add_where_as_col_to_location and w is not None:
                ws = w if isinstance(w, list) else [w]
                locs["add_data_to_col"] = {
                    _["col"]: _["val"] if isinstance(_["val"], list) else [_["val"]] for _ in ws
                }

            if add_to_table_suffix:
                new_suffix = "_".join(str(vals_out[i][k]) for k in self.col_select)
                rkw["table_suffix"] = rkw.get("table_suffix", "") + "_" + remove_bad_table_char(new_suffix)

            if self.output_file is not None:
                rkw["store_path"] = self.output_file

            # NOT json_serializable here: in-memory DataFrame sources must
            # survive for run_from_config; main() serializes when writing
            # the configs to a JSON file (where path sources are required)
            oic.append(
                {
                    "data": dc,
                    "model": m,
                    "locations": locs,
                    "pred_loc": pl,
                    "run_kwargs": rkw,
                    "comment": f"{self.comment} [xval hold-out: {vals_out[i]}]",
                }
            )
        return oic


def score_xval_predictions(
    preds: Mapping[str, pd.DataFrame],
    truth_df: pd.DataFrame,
    obs_col: str,
    *,
    inference_radius: Union[int, float],
    pred_loc_cols: Optional[List[str]] = None,
    xprt_loc_cols: Optional[List[str]] = None,
    join_round: Optional[int] = None,
) -> pd.DataFrame:
    """Score cross-validation predictions against held-out truth.

    ``preds`` maps a table name to its preds frame (one per hold-out slice,
    columns as the store's ``preds`` table: the expert and prediction
    coordinates, ``f*`` and ``y_var``). Each frame's per-expert predictions
    are glued with Gaussian weights, joined to the truth on the prediction
    coordinates, and scored with RMSE and mean NLL — the reference's
    archived evaluation flow (ref: examples/Archive/evaluate_xval_performance.py:
    16-87). Returns one row per table plus their means.

    join_round: optional decimals to round coordinates to before joining
    (the reference rounds to reconcile float drift).
    """
    from gpsat_tpu_torch.postprocess import glue_local_predictions_2d
    from gpsat_tpu_torch.utils.misc import nll, rmse

    pred_loc_cols = pred_loc_cols or ["pred_loc_x", "pred_loc_y"]
    xprt_loc_cols = xprt_loc_cols or ["x", "y"]
    assert preds, "no prediction tables to score"

    truth = truth_df.copy()
    rows = []
    for t, df in preds.items():
        glued = glue_local_predictions_2d(
            df, pred_loc_cols, xprt_loc_cols, ["f*", "y_var"], inference_radius
        )
        g = glued.reset_index()
        tr = truth
        if join_round is not None:
            g = g.copy()
            tr = truth.copy()
            for c in pred_loc_cols:
                g[c] = g[c].round(join_round)
                tr[c] = tr[c].round(join_round)
        merged = g.merge(tr[pred_loc_cols + [obs_col]], on=pred_loc_cols, how="inner")
        if len(merged) == 0:
            rows.append({"table": t, "n": 0, "rmse": np.nan, "nll": np.nan})
            continue
        sig = np.sqrt(np.clip(merged["y_var"].values, 1e-12, None))
        rows.append(
            {
                "table": t,
                "n": len(merged),
                "rmse": rmse(merged[obs_col].values, merged["f*"].values),
                "nll": nll(merged[obs_col].values, merged["f*"].values, sig),
            }
        )
    out = pd.DataFrame(rows)
    mean_row = {"table": "MEAN", "n": int(out["n"].sum()),
                "rmse": out["rmse"].mean(), "nll": out["nll"].mean()}
    return pd.concat([out, pd.DataFrame([mean_row])], ignore_index=True)


def evaluate_xval_results(
    store_path: str,
    truth_df: pd.DataFrame,
    obs_col: str,
    *,
    inference_radius: Union[int, float],
    pred_loc_cols: Optional[List[str]] = None,
    xprt_loc_cols: Optional[List[str]] = None,
    pred_table_pattern: str = r"preds_.+",
    join_round: Optional[int] = None,
) -> pd.DataFrame:
    """Score a cross-validation results store against held-out truth: every
    ``preds_<suffix>`` table (one per hold-out slice, written by the configs
    XvalConfig emits) through ``score_xval_predictions``. Reads the store
    through ``TableStore``."""
    from gpsat_tpu_torch.data.store import TableStore

    with TableStore(store_path, mode="r") as store:
        tables = [t for t in store.keys() if re.fullmatch(pred_table_pattern, t.lstrip("/"))]
        preds = {t: store.select(t).reset_index() for t in tables}
    assert preds, f"no tables matching {pred_table_pattern!r} in {store_path}"
    return score_xval_predictions(preds, truth_df, obs_col, inference_radius=inference_radius,
                                  pred_loc_cols=pred_loc_cols, xprt_loc_cols=xprt_loc_cols, join_round=join_round)


def main(config: dict = None):
    """Expand one xval config and write the hold-out configs; returns them.
    With --help, print the usage and return 0; with no config, print it and
    return 2."""
    if config is None:
        if len(sys.argv) > 1 and sys.argv[1] in ("-h", "--help"):
            print(USAGE)
            return 0
        config = get_config_from_sysargv()
    if config is None:
        print(USAGE, file=sys.stderr)
        return 2
    ref = config.get("ref_config")
    if ref is None and "ref_config_file" in config:
        with open(config["ref_config_file"]) as f:
            ref = json.load(f)
    xc = XvalConfig(ref_config=ref, xval_config=config["xval_config"])
    oic = xc.make_xval_oi_configs(
        hold_out_data_is_pred_loc=config.get("hold_out_data_is_pred_loc", True),
        add_where_as_col_to_location=config.get("add_where_as_col_to_location", False),
        add_to_table_suffix=config.get("add_to_table_suffix", True),
    )
    out_path = config.get("output_config_file", "xval_configs.json")
    with open(out_path, "w") as f:
        json.dump(json_serializable(oic), f, indent=4)
    cprint(f"wrote {len(oic)} xval configs to: {out_path}", c="OKGREEN")
    return oic


if __name__ == "__main__":
    main()
