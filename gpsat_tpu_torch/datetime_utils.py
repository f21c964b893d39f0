"""Satellite-specific datetime derivation (ref: GPSat/datetime_utils.py).

The port's own copy of ``gpsat_tpu/datetime_utils.py``. Per-row timestamps interpolated between a file's encoded start/end times
(GPOD / SARAL filename conventions), float-epoch conversion, and
year/month/day + hhmmss combination. Registered in the config_func
registry so col_funcs specs can reference them by "@name";
``utils/config_func`` imports this module at its first "@name" lookup.
"""

from __future__ import annotations

import datetime
import os
import re

import numpy as np
import pandas as pd

from gpsat_tpu_torch.utils.config_func import register_func


def _interp_file_times(dt0: np.datetime64, dt1: np.datetime64, n: int) -> np.ndarray:
    denom = max(n - 1, 1)
    delta_t = (dt1 - dt0) / denom
    return dt0 + np.arange(n) * delta_t


@register_func("from_file_start_end_datetime_GPOD")
def from_file_start_end_datetime_GPOD(f: str, df) -> np.ndarray:
    """Evenly spaced datetimes from a GPOD filename's start/end stamps,
    e.g. S3A_GPOD_SAR__SRA_A__20191031T233355_20191101T002424_... ->
    len(df) timestamps, dtype datetime64[ns]."""
    f = os.path.basename(f)
    dt0s, dt1s = f.split("_")[-5], f.split("_")[-4]
    dt0 = np.datetime64(datetime.datetime.strptime(dt0s, "%Y%m%dT%H%M%S"))
    dt1 = np.datetime64(datetime.datetime.strptime(dt1s, "%Y%m%dT%H%M%S"))
    assert len(df) > 0, "df has length 0"
    return _interp_file_times(dt0, dt1, len(df)).astype("datetime64[ns]")


@register_func("from_file_start_end_datetime_SARAL")
def from_file_start_end_datetime_SARAL(f: str, df) -> np.ndarray:
    """As above for SARAL filenames:
    SARAL_C139_0036_20200331_234125_20200401_003143_... -> datetime64[s]."""
    f = os.path.basename(f)
    fs = f.split("_")
    dt0 = np.datetime64(datetime.datetime.strptime(fs[3] + fs[4], "%Y%m%d%H%M%S"))
    dt1 = np.datetime64(datetime.datetime.strptime(fs[5] + fs[6], "%Y%m%d%H%M%S"))
    assert len(df) > 0, "df has length 0"
    return _interp_file_times(dt0, dt1, len(df)).astype("datetime64[s]")


@register_func("datetime_from_float_column")
def datetime_from_float_column(float_datetime, epoch=(1950, 1, 1), time_unit: str = "D") -> np.ndarray:
    """Float offsets since an epoch -> datetime64[s]."""
    dt = pd.to_timedelta(float_datetime, unit=time_unit) + datetime.datetime(*epoch)
    return dt.values.astype("datetime64[s]")


@register_func("date_from_datetime")
def date_from_datetime(dt) -> np.ndarray:
    """'YYYY-MM-DD HH:mm:SS' strings -> 'YYYYMMDD' strings."""
    strip = lambda x: re.sub(" .*$|-", "", x)
    return np.array([strip(_) for _ in dt])


@register_func("datetime_from_ymd_cols")
def datetime_from_ymd_cols(year, month, day, hhmmss) -> np.ndarray:
    """Separate y/m/d + hhmmss int columns -> datetime64[s]."""
    assert len(year) == len(month) == len(day) == len(hhmmss), "input columns must have equal length"
    hh = np.array([f"{int(_):06}" for _ in hhmmss])
    out = [
        f"{year[i]}-{int(month[i]):02}-{int(day[i]):02} {hh[i][0:2]}:{hh[i][2:4]}:{hh[i][4:6]}"
        for i in range(len(year))
    ]
    return np.array(out).astype("datetime64[s]")
