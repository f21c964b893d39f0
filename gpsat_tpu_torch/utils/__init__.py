"""The reference's ``GPSat.utils`` surface (ref: GPSat/utils.py), as the
port's own copy of ``gpsat_tpu/utils/__init__.py``.

Every name but ``sigmoid`` and ``inverse_sigmoid`` resolves when first read
from the module that holds it, so importing a ``gpsat_tpu_torch.utils``
submodule (the sweep's path) loads neither pandas nor the orchestrator.
"""

import numpy as _np


def sigmoid(x, low=0, high=1):
    """Scaled sigmoid mapping R -> (low, high) (ref: GPSat/utils.py:2377-2380)."""
    assert high > low
    return (high - low) / (1 + _np.exp(-_np.asarray(x, dtype=float))) + low


def inverse_sigmoid(y, low=0, high=1):
    """Inverse of :func:`sigmoid`; +/-inf outside [low, high]
    (ref: GPSat/utils.py:2382-2400 numba kernel semantics)."""
    assert high > low
    y = _np.asarray(y, dtype=float)
    with _np.errstate(divide="ignore", invalid="ignore"):
        out = -_np.log((high - low) / (y - low) - 1)
    out = _np.where(y <= low, -_np.inf, out)
    out = _np.where(y >= high, _np.inf, out)
    return out


_P = "gpsat_tpu_torch."
# name -> (module, attr)
_LAZY = {
    **{n: (_P + "utils.config_func", n) for n in ("config_func", "register_func", "REGISTERED_FUNCS",
                                                  "get_col_values")},
    **{n: (_P + "utils.grids", n) for n in ("grid_2d_flatten", "grid_nd_flatten")},
    **{n: (_P + "utils.misc", n) for n in (
        "cprint", "compare_dataframes", "get_config_from_sysargv", "guess_track_num", "json_serializable",
        "nested_dict_literal_eval", "nll", "pandas_to_dict", "rmse", "stats_on_vals", "to_array",
        "track_num_for_date", "log_lines", "not_nan", "assign_category_col", "convert_lon_lat_str",
        "diff_distance", "expand_dict_by_vals", "json_load", "move_to_archive", "pretty_print_class")},
    **{n: (_P + "utils.projections", n) for n in ("EASE2toWGS84", "EASE2toWGS84_New", "WGS84toEASE2",
                                                  "WGS84toEASE2_New")},
    **{n: (_P + "utils.tables", n) for n in (
        "array_to_dataframe", "dataframe_to_2d_array", "dataframe_to_array", "dict_of_array_to_dict_of_dataframe",
        "make_multiindex_df", "match", "mindex_df_to_dataarray", "pip_freeze_to_dataframe")},
    "get_weighted_values": (_P + "utils.weights", "get_weighted_values"),
    # names the reference keeps in GPSat/utils.py that live in more specific
    # modules here
    "sparse_true_array": (_P + "data.expert_locations", "sparse_true_array"),
    "get_previous_oi_config": (_P + "experts", "get_previous_oi_config"),
    "check_prev_oi_config": (_P + "experts", "check_prev_oi_config"),
    "get_git_information": (_P + "data.ingest", "get_git_information"),
    "glue_local_predictions": (_P + "postprocess", "glue_local_predictions"),
    "bin_obs_by_date": (_P + "data.binning", "bin_obs_by_date"),
    "softplus": (_P + "ops.transforms", "softplus"),
    "inverse_softplus": (_P + "ops.transforms", "inverse_softplus"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'gpsat_tpu_torch.utils' has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


__all__ = ["sigmoid", "inverse_sigmoid", *_LAZY]
