"""Misc utilities mirroring the reference's utils surface.

The port's own copy of ``gpsat_tpu/utils/misc.py``:
- cprint (ref: GPSat/utils.py:2402-2450), to_array (:668-...),
  json_serializable (:1366), nested_dict_literal_eval (:31),
  get_config_from_sysargv (:139-177), pandas_to_dict
- stats_on_vals (ref: GPSat/utils.py:496-554; binning's data-quality report)
- rmse / nll metrics (ref: GPSat/utils.py:2452-2464)
- guess_track_num / track_num_for_date (ref: GPSat/utils.py:2466-2489)
- compare_dataframes, json_load, not_nan, assign_category_col, log_lines,
  convert_lon_lat_str, expand_dict_by_vals, pretty_print_class,
  diff_distance, move_to_archive

The functions the sweep reaches do not import pandas; the others import it
when they run. An object can only be a DataFrame or a Series
once its caller has imported pandas, so they look for it in ``sys.modules``;
the device-facing sweep then runs where pandas is not installed.
"""

from __future__ import annotations

import ast
import datetime
import json
import sys

import numpy as np

_COLORS = {
    "HEADER": "\033[95m",
    "OKBLUE": "\033[94m",
    "OKCYAN": "\033[96m",
    "OKGREEN": "\033[92m",
    "WARNING": "\033[93m",
    "FAIL": "\033[91m",
    "ENDC": "\033[0m",
    "BOLD": "\033[1m",
    "UNDERLINE": "\033[4m",
}


def loaded_pandas():
    """The pandas module if this process has imported it, else None."""
    return sys.modules.get("pandas")


def cprint(x, c="ENDC", bcolors=None, sep=" ", end="\n"):
    print(f"{_COLORS.get(c if bcolors is None else bcolors, '')}{x}{_COLORS['ENDC']}", sep=sep, end=end)


def pandas_to_dict(x) -> dict:
    """A one-row DataFrame or a Series as a dict; a dict as it is."""
    pd = loaded_pandas()
    if pd is not None and isinstance(x, pd.Series):
        return x.to_dict()
    if pd is not None and isinstance(x, pd.DataFrame):
        assert len(x) == 1, f"DataFrame provided must have exactly 1 row, got: {len(x)}"
        return x.iloc[0].to_dict()
    assert isinstance(x, dict), f"expected Series/DataFrame/dict, got: {type(x)}"
    return x


def to_array(*args, date_format="%Y-%m-%d"):
    """Yield each arg as a numpy array (reference generator contract)."""
    pd = loaded_pandas()
    for x in args:
        if isinstance(x, np.ndarray):
            yield x
        elif isinstance(x, (int, float, bool, np.number, np.bool_)):
            yield np.array([x])
        elif isinstance(x, str):
            yield np.array([x])
        elif isinstance(x, datetime.date):
            yield np.array([x.strftime(date_format)], dtype="datetime64[D]")
        elif isinstance(x, (list, tuple)):
            yield np.array(x)
        elif pd is not None and isinstance(x, pd.Series):
            yield x.values
        elif x is None:
            yield np.array([])
        else:
            yield np.array(x)


def json_serializable(d, max_len_print: int = 100):
    """Recursively coerce a dict to JSON-serializable values (numpy scalars
    -> python, arrays -> lists, tuple keys -> str). The output equals the
    JAX package's for the same input, so stored configs compare equal
    across the two packages."""
    pd = loaded_pandas()
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            key = str(k) if isinstance(k, tuple) else k
            out[key] = json_serializable(v, max_len_print)
        return out
    if isinstance(d, (list, tuple)):
        return [json_serializable(v, max_len_print) for v in d]
    if pd is not None and isinstance(d, pd.DataFrame):
        # configs can hold in-memory DataFrames (expert locs / data source);
        # serialize a deterministic fingerprint so config-compat checks work
        import hashlib

        h = hashlib.sha1(pd.util.hash_pandas_object(d, index=False).values.tobytes()).hexdigest()
        return {"_dataframe_": {"rows": len(d), "columns": list(map(str, d.columns)), "sha1": h}}
    if pd is not None and isinstance(d, pd.Series):
        return json_serializable(d.to_dict(), max_len_print)
    if isinstance(d, np.ndarray):
        return d.tolist()
    if isinstance(d, (np.integer,)):
        return int(d)
    if isinstance(d, (np.floating,)):
        return float(d)
    if isinstance(d, (np.bool_,)):
        return bool(d)
    # pandas.Timestamp is a datetime.date
    if isinstance(d, (np.datetime64, datetime.date)):
        return str(d)
    if callable(d) and not isinstance(d, str):
        return str(d)
    return d


def nested_dict_literal_eval(d: dict, verbose: bool = False) -> dict:
    """Convert "('a', 'b')"-style string keys back to tuple keys. A list
    (a file of several configs, as the predict-only config that
    postprocessing writes) converts each of its dicts."""
    if isinstance(d, list):
        return [nested_dict_literal_eval(v, verbose) if isinstance(v, dict) else v for v in d]
    out = {}
    for k, v in d.items():
        key = k
        if isinstance(k, str) and k.startswith("(") and k.endswith(")"):
            try:
                key = ast.literal_eval(k)
            except (ValueError, SyntaxError):
                key = k
        out[key] = nested_dict_literal_eval(v, verbose) if isinstance(v, dict) else v
    return out


def get_config_from_sysargv(argv_num: int = 1):
    """Read a JSON config path from sys.argv (ref: GPSat/utils.py:139-177)."""
    config = None
    try:
        path = sys.argv[argv_num]
        assert path.endswith(".json"), f"config file: {path} does not end with .json"
        with open(path, "r") as f:
            config = nested_dict_literal_eval(json.load(f))
    except IndexError as e:
        print(f"IndexError: {e} — no config file provided on command line")
    return config


def stats_on_vals(vals, measure=None, name=None, qs=None):
    """Summary statistics DataFrame on an array (data-quality reporting)."""
    import pandas as pd

    out = {}
    vals = np.asarray(vals)
    out["measure"] = measure
    out["size"] = vals.size
    out["num_not_nan"] = int((~np.isnan(vals)).sum())
    out["num_inf"] = int(np.isinf(vals).sum())
    finite = vals[np.isfinite(vals)]
    out["min"] = finite.min() if finite.size else np.nan
    out["mean"] = finite.mean() if finite.size else np.nan
    out["max"] = finite.max() if finite.size else np.nan
    out["std"] = finite.std() if finite.size else np.nan
    out["skew"] = (
        float(((finite - finite.mean()) ** 3).mean() / (finite.std() ** 3)) if finite.size else np.nan
    )
    out["kurtosis"] = (
        float(((finite - finite.mean()) ** 4).mean() / (finite.std() ** 4) - 3.0) if finite.size else np.nan
    )
    if qs is None:
        qs = [0.05] + list(np.arange(0.1, 1.0, 0.1).round(1)) + [0.95]
    quantiles = {f"q{q:.2f}": np.quantile(finite, q) if finite.size else np.nan for q in qs}
    out = {**out, **quantiles}
    return pd.DataFrame.from_dict(out, orient="index", columns=[name if name else "vals"])


def rmse(y_true, y_pred):
    return np.sqrt(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2))


def nll(y_true, mu, sig, return_mean: bool = True):
    """Negative log likelihood of y under N(mu, sig^2)."""
    y_true, mu, sig = np.asarray(y_true), np.asarray(mu), np.asarray(sig)
    out = 0.5 * np.log(2 * np.pi * sig**2) + ((y_true - mu) ** 2) / (2 * sig**2)
    return out.mean() if return_mean else out


def guess_track_num(x, thresh, start_track: int = 0):
    """Label satellite tracks: increment when the gap between consecutive
    values exceeds thresh (ref: GPSat/utils.py:2466-2477)."""
    x = np.asarray(x)
    dx = np.abs(np.diff(x, prepend=x[0]))
    return np.cumsum(dx > thresh) + start_track


def track_num_for_date(x):
    """Per-date track numbering from datetimes (ref: GPSat/utils.py:2480-2489)."""
    import pandas as pd

    x = pd.Series(pd.to_datetime(np.asarray(x)))
    date = x.dt.date
    out = np.zeros(len(x), dtype=int)
    for d in pd.unique(date):
        sel = (date == d).values
        gaps = x[sel].diff().dt.total_seconds().fillna(0.0).values
        out[sel] = np.cumsum(gaps > 60.0)
    return out


def compare_dataframes(df1, df2, merge_on, val_cols):
    """Merge two frames on keys and report abs/rel differences of val_cols
    (ref: GPSat/utils.py:2510-...; used by the binning regression test)."""
    merged = df1.merge(df2, on=merge_on, how="outer", suffixes=("_1", "_2"), indicator=True)
    for vc in val_cols:
        merged[f"{vc}_abs_diff"] = np.abs(merged[f"{vc}_1"] - merged[f"{vc}_2"])
        with np.errstate(divide="ignore", invalid="ignore"):
            merged[f"{vc}_rel_diff"] = merged[f"{vc}_abs_diff"] / np.abs(merged[f"{vc}_1"])
    return merged


def json_load(path: str) -> dict:
    """Load JSON with tuple-key restoration (ref: utils.py:87)."""
    with open(path) as f:
        return nested_dict_literal_eval(json.load(f))


def not_nan(x) -> np.ndarray:
    """~isnull as an array (ref: utils.py:965)."""
    import pandas as pd

    return ~pd.isnull(np.asarray(x))


def assign_category_col(val: str, df, categories=None):
    """Constant categorical column of len(df) (ref: utils.py:1041)."""
    import pandas as pd

    return pd.Categorical([val] * len(df), categories=categories)


def log_lines(*args, level: str = "debug"):
    """Send each arg to the logging module (ref: utils.py:1329)."""
    import logging

    fn = getattr(logging, level, logging.debug)
    for a in args:
        fn(str(a) if not isinstance(a, str) else a)


def convert_lon_lat_str(x: str) -> float:
    """Parse "74 0.1878 N" / "140 0.1198 W"-style strings to decimal
    degrees (ref: utils.py:1885)."""
    assert isinstance(x, str), f"expected str, got: {type(x)}"
    parts = x.strip().split(" ")
    deg, minutes, hemi = float(parts[0]), float(parts[1]), parts[-1].upper()
    out = deg + minutes / 60.0
    if hemi in ("S", "W"):
        out = -out
    return out


def expand_dict_by_vals(d: dict, expand_keys) -> list:
    """Cartesian expansion of list-valued keys into a list of dicts
    (ref: utils.py:1933)."""
    import itertools

    expand_keys = [expand_keys] if isinstance(expand_keys, str) else list(expand_keys)
    lists = [d[k] if isinstance(d[k], list) else [d[k]] for k in expand_keys]
    out = []
    for combo in itertools.product(*lists):
        new = {k: v for k, v in d.items() if k not in expand_keys}
        new.update(dict(zip(expand_keys, combo)))
        out.append(new)
    return out


def pretty_print_class(cls) -> str:
    """'module.ClassName' without the <class ...> wrapper (ref: utils.py:1965)."""
    s = str(cls if isinstance(cls, type) else type(cls))
    return s.split("'")[1] if "'" in s else s


def diff_distance(x, p: int = 1) -> np.ndarray:
    """|diff| with a leading NaN, for track-gap detection (ref: utils.py:2490)."""
    x = np.asarray(x, dtype=float)
    d = np.abs(np.diff(x)) ** p
    return np.concatenate([[np.nan], d])


def move_to_archive(top_dir: str, file_names=None, suffix: str = "", archive_sub_dir: str = "Archive",
                    verbose: bool = False):
    """Move files into an Archive/ subdirectory (ref: utils.py:178)."""
    import os
    import shutil

    assert os.path.isdir(top_dir), f"not a directory: {top_dir}"
    file_names = [file_names] if isinstance(file_names, str) else list(file_names or [])
    dst_dir = os.path.join(top_dir, archive_sub_dir)
    os.makedirs(dst_dir, exist_ok=True)
    for fn in file_names:
        src = os.path.join(top_dir, fn)
        if not os.path.exists(src):
            if verbose:
                print(f"missing, skipping: {src}")
            continue
        base, ext = os.path.splitext(fn)
        shutil.move(src, os.path.join(dst_dir, f"{base}{suffix}{ext}"))
