"""Misc utilities the orchestrator uses.

The port's own copy of the parts of ``gpsat_tpu/utils/misc.py`` this slice
needs: ``cprint``, ``json_serializable``, ``pandas_to_dict``, ``to_array``,
``nested_dict_literal_eval``, ``get_config_from_sysargv`` and
``stats_on_vals`` (binning's data-quality report).

None of them but ``stats_on_vals`` imports pandas. An object can only be a DataFrame or a Series
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
    """Convert "('a', 'b')"-style string keys back to tuple keys."""
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
