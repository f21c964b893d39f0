"""Config-driven function application — the reference's executable-config idiom.

The port's own copy of ``gpsat_tpu/utils/config_func.py`` (ref:
GPSat/utils.py:311-493): a JSON-storable spec {func, source, args, kwargs,
col_args, col_kwargs} applied to values and/or columns. The selection DSL
(row_select / where / col_funcs) and dynamic global_select lambdas call it.

``df`` is a DataFrame or any mapping of column name -> array. Like the
reference, string funcs are evaluated: ``lambda ...`` strings via eval,
operator shorthands via a generated lambda, and names imported from
``source``; "@name" looks up REGISTERED_FUNCS without eval. The registry
holds what the JAX package's does: the projections (``@WGS84toEASE2``,
``@EASE2toWGS84``), the datetime helpers below and, from the first "@name"
lookup on, the satellite datetime funcs of ``gpsat_tpu_torch/
datetime_utils.py`` (which imports pandas).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from gpsat_tpu_torch.utils.misc import loaded_pandas
from gpsat_tpu_torch.utils.projections import EASE2toWGS84, WGS84toEASE2


def _to_datetime(x):
    import pandas as pd

    return pd.to_datetime(x).values


def _days_since_epoch(x):
    import pandas as pd

    return (pd.to_datetime(x) - pd.Timestamp("1970-01-01")).total_seconds().values / 86400.0


# preferred non-eval path: "@name" keys resolve here; the datetime helpers
# are the named spelling of lambdas common in OI configs
REGISTERED_FUNCS = {
    "WGS84toEASE2": WGS84toEASE2,
    "EASE2toWGS84": EASE2toWGS84,
    "to_datetime": _to_datetime,
    "days_since_epoch": _days_since_epoch,
}


def register_func(name: str):
    """Decorator: register ``f`` as ``"@name"``."""

    def deco(f):
        REGISTERED_FUNCS[name] = f
        return f

    return deco


def eval_namespace() -> dict:
    """Globals for eval'd config strings: numpy as ``np`` and, where it is
    installed, pandas as ``pd`` (reference configs use both)."""
    ns = {"np": np}
    try:
        import pandas as pd
    except ImportError:
        return ns
    ns["pd"] = pd
    return ns


def get_col_values(df, col, return_numpy: bool = True):
    if not hasattr(df, "loc"):  # a mapping of column name -> array
        return np.asarray(df[col])
    try:
        out = df.loc[:, col]
    except KeyError:
        assert isinstance(col, int), f"col: {col} not a column name and not an int position"
        out = df.iloc[:, col]
    return out.values if return_numpy else out


def config_func(
    func,
    source: Optional[str] = None,
    args=None,
    kwargs=None,
    col_args=None,
    col_kwargs=None,
    df=None,
    filename_as_arg: bool = False,
    filename: Optional[str] = None,
    col_numpy: bool = True,
):
    """Apply ``func`` (callable | "@registered" | "lambda ..." | operator
    string | importable name) to args and/or columns of ``df``.

    Column args are placed before literal args; on kwarg-name collision the
    literal kwargs win (matching the reference's merge order). Returns numpy
    when the result is a Series.
    """
    args = [] if args is None else (args if isinstance(args, list) else [args])
    col_args = [] if col_args is None else (col_args if isinstance(col_args, list) else [col_args])
    kwargs = kwargs or {}
    col_kwargs = col_kwargs or {}
    assert isinstance(kwargs, dict), "kwargs must be a dict"
    assert isinstance(col_kwargs, dict), "col_kwargs must be a dict"

    if df is None:
        assert len(col_args) == 0, f"df not provided, but col_args: {col_args} were"
        assert len(col_kwargs) == 0, f"df not provided, but col_kwargs: {col_kwargs} were"
    else:
        col_args = [get_col_values(df, c, return_numpy=col_numpy) for c in col_args]
        col_kwargs = {k: get_col_values(df, c, return_numpy=col_numpy) for k, c in col_kwargs.items()}

    args = col_args + args
    if filename_as_arg and filename is not None:
        args = [filename] + args
    # literal kwargs take precedence over column kwargs on collision
    # (matches the reference's actual merge order, utils.py:478)
    kwargs = {**col_kwargs, **kwargs}

    if isinstance(func, str):
        if func.startswith("@"):
            name = func[1:]
            from gpsat_tpu_torch import datetime_utils  # noqa: F401  (registers its funcs)

            assert name in REGISTERED_FUNCS, f"'@{name}' not in registered funcs: {sorted(REGISTERED_FUNCS)}"
            fun = REGISTERED_FUNCS[name]
        elif re.search("^lambda", func):
            fun = eval(func, eval_namespace())  # noqa: S307 — reference-compat executable config
        elif re.search(r"[\|&\=\+\-\*/\%<>]", func):
            fun = lambda arg1, arg2: eval(f"arg1 {func} arg2")  # noqa: S307,E731
        else:
            try:
                fun = eval(func, eval_namespace())  # noqa: S307
            except NameError:
                assert source is not None, f"NameError on eval({func}) and no source to import from"
                import importlib

                mod = importlib.import_module(source)
                fun = getattr(mod, func)
    else:
        assert callable(func), "func is neither a string nor callable"
        fun = func

    out = fun(*args, **kwargs)
    pd = loaded_pandas()
    if pd is not None and isinstance(out, pd.Series):
        out = out.values
    return out
