"""DataLoader facade — migration surface for reference users.

The reference exposes everything through one god-class
(``GPSat.dataloader.DataLoader``, ref: GPSat/dataloader.py:25). The port,
like ``gpsat_tpu``, splits the functionality into focused modules
(gpsat_tpu_torch.data.*); this facade, its own copy of
``gpsat_tpu/dataloader.py``, re-exposes the reference's classmethod surface
so code written against the reference keeps working:

    from gpsat_tpu_torch.dataloader import DataLoader
    df = DataLoader.load(source=..., where=[...], col_funcs={...})
"""

from __future__ import annotations

import pandas as pd

from gpsat_tpu_torch.data import binning as _binning
from gpsat_tpu_torch.data import dataloader as _dl
from gpsat_tpu_torch.data import expert_locations as _el
from gpsat_tpu_torch.data import ingest as _ingest
from gpsat_tpu_torch.data import select as _sel
from gpsat_tpu_torch.data.store import TableStore


class DataLoader:
    file_suffix_engine_map = _dl.FILE_SUFFIX_ENGINE_MAP

    # --- loading / selection (ref: dataloader.py:1011-1800) ---
    load = staticmethod(_dl.load)
    add_cols = staticmethod(_dl.add_cols)
    add_data_to_col = staticmethod(_dl.add_data_to_col)
    data_select = staticmethod(_sel.data_select)
    row_select_bool = staticmethod(_sel.row_select_bool)
    local_data_select = staticmethod(_sel.local_data_select)
    get_where_list = staticmethod(_sel.get_where_list)
    get_where_list_legacy = staticmethod(_sel.get_where_list_legacy)
    kdt_tree_list_for_local_select = staticmethod(_sel.build_kdtrees)
    _bool_numpy_from_where = staticmethod(_sel.bool_array_from_where)

    @staticmethod
    def is_list_of_dict(lst) -> bool:
        """True iff lst is a list whose elements are all dicts
        (ref: dataloader.py is_list_of_dict)."""
        return isinstance(lst, list) and all(isinstance(x, dict) for x in lst)

    # --- multi-file ingest (ref: dataloader.py:232-1009) ---
    read_from_multiple_files = staticmethod(_ingest.read_from_multiple_files)
    read_flat_files = staticmethod(_ingest.read_flat_files)
    read_from_pkl_dict = staticmethod(_ingest.read_from_pkl_dict)
    read_from_npy = staticmethod(_ingest.read_from_npy)
    get_run_info = staticmethod(_ingest.get_run_info)

    # --- expert locations (ref: dataloader.py:2610-2805) ---
    generate_local_expert_locations = staticmethod(_el.generate_local_expert_locations)
    get_masks_for_expert_loc = staticmethod(_el.get_masks_for_expert_loc)

    # --- binning (deprecated in the reference; modern path is DataPrep) ---
    bin_data_by = staticmethod(_binning.bin_data_by)
    bin_data = staticmethod(_binning.bin_data)

    # --- store helpers (HDFStore-era names; ref: dataloader.py:563-746) ---
    @staticmethod
    def connect_to_hdf_store(path: str, mode: str = "a") -> TableStore:
        return TableStore(path, mode=mode)

    @staticmethod
    def hdf_tables_in_store(store: TableStore) -> list:
        return store.keys()

    @staticmethod
    def get_keys(path: str) -> list:
        with TableStore(path, mode="r") as s:
            return s.keys()

    @staticmethod
    def read_hdf(path: str, table: str, where=None) -> pd.DataFrame:
        with TableStore(path, mode="r") as s:
            return s.select(table, where=where)

    @staticmethod
    def write_to_hdf(df: pd.DataFrame, path: str, table: str, append: bool = True):
        with TableStore(path) as s:
            if append:
                s.append(table, df)
            else:
                s.put(table, df, replace=True)

    # --- table marshalling (ref: dataloader.py:2451-2608) ---
    @staticmethod
    def make_multiindex_df(*args, **kwargs):
        from gpsat_tpu_torch.utils.tables import make_multiindex_df as _f

        return _f(*args, **kwargs)

    @staticmethod
    def mindex_df_to_mindex_dataarray(*args, **kwargs):
        """Reference name for utils.tables.mindex_df_to_dataarray
        (ref: dataloader.py:2529)."""
        from gpsat_tpu_torch.utils.tables import mindex_df_to_dataarray as _f

        return _f(*args, **kwargs)

    @staticmethod
    def write_to_netcdf(ds, path: str, mode: str = "w", **to_netcdf_kwargs):
        """Write variables to a netCDF4(-compatible HDF5) file
        (ref: dataloader.py write_to_netcdf — there a thin xr.Dataset
        wrapper; this accepts what data.netcdf.write_netcdf takes: a DataFrame (indexed by dims) or a
        {name: (dims, values)} dict, written through the port's HDF5 codec
        with dimension scales that round-trip through read_netcdf)."""
        assert mode == "w", f"only mode='w' is supported, got: {mode}"
        from gpsat_tpu_torch.data.netcdf import write_netcdf as _w

        return _w(path, ds, **to_netcdf_kwargs)

    @staticmethod
    def get_attribute_from_table(source, table: str, attribute_name: str):
        """Read a JSON attr from a table (ref: dataloader.py:2981)."""
        if isinstance(source, TableStore):
            return source.get_attrs(table).get(attribute_name)
        with TableStore(source, mode="r") as s:
            return s.get_attrs(table).get(attribute_name)


class DataPrep:
    """Modern binning facade (ref: GPSat/dataprepper.py:23-401)."""

    bin_data_by = staticmethod(_binning.bin_data_by)
    bin_data = staticmethod(_binning.bin_data)
