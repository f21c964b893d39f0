"""Raw-file ingest: flat files -> a single observations table, resumable.

The port's own copy of ``gpsat_tpu/data/ingest.py``; the stores it writes
are the port's ``TableStore`` (the JAX package's format). netCDF sources
(``read_engine`` "nc", "netcdf", "xarray") go through ``data/netcdf``'s
reader (the port's own HDF5 codec, no h5py), their dimensions reset to
columns.

Re-implements the reference's ingest path:
- ``read_from_multiple_files`` (ref: GPSat/dataloader.py:232-442): walk
  directories, regex-match csv files, read each, apply col_funcs (with the
  filename available as an argument, for e.g. satellite-datetime
  derivation) and row_select, concatenate.
- ``read_and_store`` CLI flow (ref: GPSat/read_and_store.py:67-316): batch
  over sub-directories, append to a ``data`` table, record each completed
  batch in a ``_<table>_batches`` ledger plus a config-id attr so re-runs
  skip completed batches (resumable, dedup ingest).
- ``get_run_info`` provenance (ref: GPSat/dataloader.py:1974-2042).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from datetime import datetime
from typing import List, Optional

import numpy as np
import pandas as pd

from gpsat_tpu_torch.data import select as sel
from gpsat_tpu_torch.data.dataloader import add_cols
from gpsat_tpu_torch.data.store import TableStore
from gpsat_tpu_torch.utils.misc import cprint, json_serializable


def get_git_information() -> dict:
    out = {}
    for key, cmd in {
        "branch": ["git", "rev-parse", "--abbrev-ref", "HEAD"],
        "commit": ["git", "rev-parse", "HEAD"],
        "remote": ["git", "remote", "-v"],
    }.items():
        try:
            out[key] = subprocess.check_output(cmd, stderr=subprocess.DEVNULL).decode().strip()
        except Exception:
            out[key] = None
    return out


def get_run_info(script_path: Optional[str] = None) -> dict:
    info = {
        "run_time": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        "python_executable": sys.executable,
        "script_path": script_path or (sys.argv[0] if sys.argv else None),
    }
    info.update(get_git_information())
    return info


def get_dirs_to_search(base_dirs, sub_dirs=None, walk: bool = False) -> List[str]:
    """Explicit dirs x sub_dirs, or a full os.walk discovery
    (ref: read_and_store.py:29-64)."""
    base_dirs = [base_dirs] if isinstance(base_dirs, str) else list(base_dirs)
    out = []
    if walk:
        for b in base_dirs:
            for root, _, _ in os.walk(b):
                out.append(root)
    elif sub_dirs:
        sub_dirs = [sub_dirs] if isinstance(sub_dirs, str) else list(sub_dirs)
        for b in base_dirs:
            for s in sub_dirs:
                out.append(os.path.join(b, s))
    else:
        out = base_dirs
    return out


def read_from_multiple_files(
    file_dirs,
    file_regex: str,
    read_engine: str = "csv",
    col_funcs: Optional[dict] = None,
    row_select: Optional[list] = None,
    col_select: Optional[list] = None,
    sub_dirs=None,
    read_kwargs: Optional[dict] = None,
    strict: bool = True,
    verbose: bool = False,
) -> pd.DataFrame:
    """Read every regex-matched file under file_dirs into one DataFrame."""
    read_kwargs = read_kwargs or {}
    file_dirs = [file_dirs] if isinstance(file_dirs, str) else list(file_dirs)
    if sub_dirs:
        file_dirs = get_dirs_to_search(file_dirs, sub_dirs=sub_dirs)

    assert read_engine in ("csv", "tsv", "read_csv", "nc", "netcdf", "xarray"), (
        f"read_engine: {read_engine} not supported"
    )

    frames = []
    for d in file_dirs:
        if not os.path.isdir(d):
            msg = f"directory does not exist: {d}"
            if strict:
                raise FileNotFoundError(msg)
            cprint(msg + " — skipping", c="WARNING")
            continue
        for fname in sorted(os.listdir(d)):
            if not re.search(file_regex, fname):
                continue
            path = os.path.join(d, fname)
            if verbose:
                print(f"reading: {path}")
            kw = dict(read_kwargs)
            if read_engine in ("nc", "netcdf", "xarray"):
                # the reference reads nc through xr.open_dataset +
                # to_dataframe (GPSat/dataloader.py:388-394); here through
                # the codec's reader, the dims kept as columns so col and row
                # selections see them
                from gpsat_tpu_torch.data.netcdf import read_netcdf

                df = read_netcdf(path, **kw).reset_index()
            else:
                if read_engine == "tsv":
                    kw.setdefault("sep", "\t")
                df = pd.read_csv(path, **kw)
            add_cols(df, col_funcs, filename=path)
            if row_select is not None:
                df = df.loc[sel.row_select_bool(df, row_select)]
            if col_select is not None:
                df = df.loc[:, col_select]
            frames.append(df)
    assert frames, f"no files matching regex: '{file_regex}' found in {file_dirs}"
    return pd.concat(frames, axis=0).reset_index(drop=True)


def read_from_pkl_dict(
    pkl_files,
    pkl_dir: Optional[str] = None,
    default_name: str = "obs",
    strict: bool = True,
    dim_names: Optional[list] = None,
) -> pd.DataFrame:
    """Legacy pickled dict-of-arrays -> long DataFrame
    (ref: GPSat/dataloader.py:783-933): each pickle holds
    {measure: {source: ndarray}}; dims are exploded into columns."""
    import pickle

    if isinstance(pkl_files, str):
        pkl_files = {default_name: [pkl_files]}
    elif isinstance(pkl_files, list):
        pkl_files = {default_name: pkl_files}

    frames = []
    for name, files in pkl_files.items():
        for f in files if isinstance(files, list) else [files]:
            path = os.path.join(pkl_dir, f) if pkl_dir else f
            if not os.path.exists(path):
                msg = f"pickle file does not exist: {path}"
                if strict:
                    raise FileNotFoundError(msg)
                cprint(msg + " — skipping", c="WARNING")
                continue
            with open(path, "rb") as fh:
                obj = pickle.load(fh)
            assert isinstance(obj, dict), f"expected dict in {path}, got {type(obj)}"
            for source, arr in obj.items():
                arr = np.asarray(arr)
                dims = dim_names or [f"_dim_{i}" for i in range(arr.ndim)]
                idx = np.indices(arr.shape).reshape(arr.ndim, -1)
                data = {dims[i]: idx[i] for i in range(arr.ndim)}
                data[name] = arr.ravel()
                df = pd.DataFrame(data)
                df["source"] = str(source)
                frames.append(df)
    assert frames, "no pickle data read"
    return pd.concat(frames, ignore_index=True)


def read_from_npy(
    npy_files,
    npy_dir: Optional[str] = None,
    dims: Optional[list] = None,
    flatten_xy: bool = True,
    return_xarray: bool = False,
) -> pd.DataFrame:
    """Legacy npy grids -> long DataFrame (ref: GPSat/dataloader.py:935-1009).

    npy_files: {col_name: file} or list/str; each array shares a grid shape.
    """
    assert not return_xarray, "xarray output is not supported in this build (use the DataFrame)"
    if isinstance(npy_files, str):
        npy_files = {"obs": npy_files}
    elif isinstance(npy_files, list):
        npy_files = {os.path.splitext(os.path.basename(f))[0]: f for f in npy_files}

    cols = {}
    shape = None
    for name, f in npy_files.items():
        path = os.path.join(npy_dir, f) if npy_dir else f
        arr = np.load(path)
        if shape is None:
            shape = arr.shape
        assert arr.shape == shape, f"shape mismatch for {name}: {arr.shape} vs {shape}"
        cols[name] = arr
    dims = dims or [f"_dim_{i}" for i in range(len(shape))]
    idx = np.indices(shape).reshape(len(shape), -1)
    data = {dims[i]: idx[i] for i in range(len(shape))}
    for name, arr in cols.items():
        data[name] = arr.ravel()
    df = pd.DataFrame(data)
    return df


def read_flat_files(file_dirs, file_regex: str, sub_dirs=None, read_csv_kwargs=None, col_funcs=None) -> pd.DataFrame:
    """Legacy flat-file reader (ref: GPSat/dataloader.py:446) — thin wrapper
    over read_from_multiple_files."""
    return read_from_multiple_files(
        file_dirs=file_dirs,
        file_regex=file_regex,
        sub_dirs=sub_dirs,
        read_kwargs=read_csv_kwargs,
        col_funcs=col_funcs,
    )


def read_and_store(
    output: dict,
    file_dirs,
    file_regex: str,
    sub_dirs=None,
    batch: bool = True,
    col_funcs: Optional[dict] = None,
    row_select: Optional[list] = None,
    col_select: Optional[list] = None,
    read_engine: str = "csv",
    read_kwargs: Optional[dict] = None,
    verbose: bool = False,
) -> str:
    """Ingest raw files into ``output['file']``'s ``output.get('table', 'data')``
    table, one batch per directory, resumably (batch ledger)."""
    out_file = output["file"]
    table = output.get("table", "data")
    ledger_table = f"_{table}_batches"

    config = json_serializable(
        dict(
            file_dirs=file_dirs,
            file_regex=file_regex,
            sub_dirs=sub_dirs,
            col_funcs=col_funcs,
            row_select=row_select,
            col_select=col_select,
            read_engine=read_engine,
        )
    )
    cfg_str = json.dumps(config, sort_keys=True)

    dirs = get_dirs_to_search(file_dirs, sub_dirs=sub_dirs) if batch else [None]
    if os.path.dirname(out_file):
        os.makedirs(os.path.dirname(out_file), exist_ok=True)

    with TableStore(out_file) as store:
        # config-id matching: a different config must not silently append
        # into the same table (ref: read_and_store.py:181-215)
        attrs = store.get_attrs(table)
        prev_cfg = attrs.get("raw_data_config")
        if prev_cfg is not None and json.dumps(prev_cfg, sort_keys=True) != cfg_str:
            raise ValueError(
                f"output table '{table}' in {out_file} was created with a different config; "
                "use a new file/table or delete the existing one"
            )
        prev_batches = set()
        if ledger_table in store:
            prev_batches = set(store.select(ledger_table, set_index=False)["batch"].tolist())

        for d in dirs:
            batch_key = d if d is not None else "<all>"
            if batch_key in prev_batches:
                cprint(f"batch already ingested, skipping: {batch_key}", c="OKCYAN")
                continue
            try:
                df = read_from_multiple_files(
                    file_dirs=[d] if d is not None else file_dirs,
                    file_regex=file_regex,
                    read_engine=read_engine,
                    col_funcs=col_funcs,
                    row_select=row_select,
                    col_select=col_select,
                    read_kwargs=read_kwargs,
                    verbose=verbose,
                )
            except AssertionError as e:
                cprint(f"batch {batch_key}: {e} — skipping", c="WARNING")
                continue
            store.append(table, df)
            store.append(
                ledger_table,
                pd.DataFrame({"batch": [batch_key], "rows": [len(df)], "when": [datetime.now().isoformat()]}),
            )
            cprint(f"ingested batch {batch_key}: {len(df)} rows", c="OKGREEN")

        store.put_attrs(table, raw_data_config=config, run_info=json_serializable(get_run_info()))
    return out_file
