"""Write the HDF5 fixtures that the port's codec is held to where h5py is absent.

    python tools/make_hdf5_fixtures.py [--out tests/fixtures/hdf5]

Needs h5py and the JAX package (it runs on the CPU, with
``JAX_PLATFORMS=cpu``). It writes, under ``--out``:

- PyTables-layout stores (pandas ``format="table"`` frames, laid out as
  pandas and PyTables lay them out, with an ``_i_table`` index subgroup):
  uncompressed, zlib with shuffle, blosc lz4 and bzip2 chunks (the last two
  through ``write_direct_chunk``: h5py has neither filter);
- a PyTables results store of chip_smoke.py phase 7's first 64 experts:
  ``lengthscales``, ``kernel_variance`` and ``likelihood_variance`` tables
  multi-indexed by the expert coordinates, as GPSat writes them;
- netCDF-4-layout files: HDF5's earliest format, netCDF-C's (superblock 2
  and version-2 headers with creation order tracked, libver v1.8), N-D
  chunked variables with edge chunks under deflate, shuffle and fletcher32,
  phony dimensions, CF datetimes, and 20 variables and attributes (dense
  links and attributes);
- the later formats h5py writes (``check_structure`` asserts each file
  holds what it is there for): at libver "latest", a copy of the results
  store in chunks of two rows (extensible arrays past their index block),
  an extensible array of 10,000 one-row chunks (secondary blocks), one
  whose chunks reach paged data blocks (a swizzled unlimited dim), fixed
  arrays of 1,200 chunks (paged, a page never written; partial edge
  chunks stored unfiltered), single-chunk, implicit and version-2 B-tree
  indexes, and h5py's lzf filter with one chunk stored raw; netCDF-C's
  committed enum, compound and vlen types; a 512-byte user block;
- two results stores as the JAX package's TableStore writes them through
  h5py, at libver "latest" with deflate+shuffle columns and at "v108"
  (chunk B-trees of K = 8): each the first half of chip_smoke.py's
  ``restart_oi`` run, which phase 17 (h) restarts (no expected frame: the
  rows come from a fit on the CPU);
- ``expected.npz``: each fixture's frame as the JAX package's readers
  (``gpsat_tpu.data.pytables_compat.read_table``,
  ``gpsat_tpu.data.netcdf.read_netcdf``) give it, through h5py; its
  ``meta`` entry (JSON) says which file, reader and table each frame is;
- ``MANIFEST.txt``: the files and what h5py could not lay out the way
  PyTables or netCDF-C would.

The writers are also what ``tests/test_torch_hdf5_formats.py`` and
``tests/test_torch_hdf5_append.py`` call to write their variants.
"""

from __future__ import annotations

import argparse
import bz2
import contextlib
import json
import pickle
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# PyTables' filter ids and the blosc filter's compressor code for lz4
BLOSC_ID, BZIP2_ID, BLOSC_LZ4 = 32001, 307, 1
PHONY_NAME = b"This is a netCDF dimension but not a netCDF variable."
LIBVER = {"earliest": "earliest", "earliest_v108": ("earliest", "v108"), "v108": ("v108", "v108"),
          "latest": "latest"}


# --------------------------------------------------------------------------
# PyTables layout
# --------------------------------------------------------------------------


def _bytes_attr(obj, name, text: str):
    obj.attrs[name] = np.bytes_(text.encode())


def _table_type(dtype: np.dtype, bitfields=()):
    """The HDF5 compound type of a table's rows at numpy's offsets; the
    members named in ``bitfields`` as 8-bit bitfields (PyTables' bool)."""
    from h5py import h5t

    ct = h5t.create(h5t.COMPOUND, dtype.itemsize)
    for name in dtype.names:
        sub, offset = dtype.fields[name][:2]
        base, shape = (sub.subdtype if sub.subdtype else (sub, ()))
        mt = h5t.STD_B8LE if name in bitfields else h5t.py_create(base)
        ct.insert(name.encode(), offset, h5t.array_create(mt, shape) if shape else mt)
    return ct


def write_frame_table(f, key, *, index_fields, blocks, data_columns=(), storage="plain", chunk_rows=64,
                      bitfields=()):
    """One pandas ``frame_table`` group, as
    ``tests/test_pytables_compat.py::_write_frame_table`` lays it out, in a
    chunked, resizable table of ``chunk_rows`` rows through ``storage``:
    "plain", "zlib" (deflate after shuffle), "blosc" (lz4, byte shuffle) or
    "bzip2"; with PyTables' own attributes and an ``_i_table`` index
    subgroup. index_fields: {name: (values, kind)}; blocks: [(field,
    colnames, 2-d values[, dtype_str])]; data_columns: [(field, values,
    dtype_str)]; bitfields: fields written as 8-bit bitfields."""
    from h5py import h5d, h5p, h5s, h5z

    from gpsat_tpu_torch.data.blosc import blosc_encode

    grp = f.create_group(key)
    for name, text in (("CLASS", "GROUP"), ("TITLE", ""), ("VERSION", "1.0"), ("pandas_type", "frame_table"),
                       ("pandas_version", "0.15.2"), ("table_type", "appendable_frame"), ("encoding", "UTF-8"),
                       ("errors", "strict")):
        _bytes_attr(grp, name, text)
    grp.attrs["index_cols"] = np.void(pickle.dumps([(0, n) for n in index_fields]))
    grp.attrs["values_cols"] = np.void(pickle.dumps([b[0] for b in blocks] + [d[0] for d in data_columns]))
    grp.attrs["data_columns"] = np.void(pickle.dumps([d[0] for d in data_columns]))
    grp.attrs["levels"] = np.int64(len(index_fields))

    dtype = [(n, vals.dtype) for n, (vals, _) in index_fields.items()]
    dtype += [(fn, vals.dtype, (vals.shape[1],)) for fn, _, vals, *_ in blocks]
    dtype += [(fn, vals.dtype) for fn, vals, _ in data_columns]
    n = len(next(iter(index_fields.values()))[0])
    rec = np.zeros(n, dtype=dtype)
    for name, (vals, _) in index_fields.items():
        rec[name] = vals
    for fn, _, vals, *_ in blocks:
        rec[fn] = vals
    for fn, vals, _ in data_columns:
        rec[fn] = vals

    ftype = _table_type(rec.dtype, bitfields)
    dcpl = h5p.create(h5p.DATASET_CREATE)
    dcpl.set_chunk((chunk_rows,))
    size = rec.dtype.itemsize
    if storage == "zlib":
        dcpl.set_shuffle()
        dcpl.set_deflate(5)
    elif storage == "blosc":  # PyTables' cd_values: versions, typesize, chunk bytes, level, shuffle, compressor
        dcpl.set_filter(BLOSC_ID, h5z.FLAG_OPTIONAL, (2, 2, size, size * chunk_rows, 5, 1, BLOSC_LZ4))
    elif storage == "bzip2":
        dcpl.set_filter(BZIP2_ID, h5z.FLAG_OPTIONAL, (9,))
    elif storage != "plain":
        raise ValueError(f"unknown storage {storage!r}")
    dsid = h5d.create(grp.id, b"table", ftype, h5s.create_simple((n,), (h5s.UNLIMITED,)), dcpl=dcpl)
    if storage in ("blosc", "bzip2"):
        for lo in range(0, n, chunk_rows):
            chunk = np.zeros(chunk_rows, rec.dtype)
            part = rec[lo:lo + chunk_rows]
            chunk[:len(part)] = part
            raw = chunk.tobytes()
            blob = blosc_encode(raw, size, cname="lz4", shuffle=1) if storage == "blosc" else bz2.compress(raw, 9)
            dsid.write_direct_chunk((lo,), blob, filter_mask=0)
    else:
        dsid.write(h5s.ALL, h5s.ALL, rec, mtype=ftype)
    ds = grp["table"]
    for name, text in (("CLASS", "TABLE"), ("VERSION", "2.7"), ("TITLE", "")):
        _bytes_attr(ds, name, text)
    ds.attrs["NROWS"] = np.int64(n)
    j = 0
    for name, (vals, kind) in index_fields.items():
        _bytes_attr(ds, f"FIELD_{j}_NAME", name)
        ds.attrs[f"FIELD_{j}_FILL"] = np.zeros((), vals.dtype)
        _bytes_attr(ds, f"{name}_kind", kind)
        j += 1
    for fn, cols, _, *dt in blocks:
        _bytes_attr(ds, f"FIELD_{j}_NAME", fn)
        ds.attrs[f"{fn}_kind"] = np.void(pickle.dumps(list(cols)))
        if dt:
            _bytes_attr(ds, f"{fn}_dtype", dt[0])
        j += 1
    for fn, _, dtype_str in data_columns:
        _bytes_attr(ds, f"FIELD_{j}_NAME", fn)
        ds.attrs[f"{fn}_kind"] = np.void(pickle.dumps([fn]))
        _bytes_attr(ds, f"{fn}_dtype", dtype_str)
        j += 1
    # PyTables' index of the first index field: sorted values and their row numbers, chunked
    idx = grp.create_group("_i_table").create_group(next(iter(index_fields)))
    _bytes_attr(idx, "CLASS", "INDEX")
    first = rec[next(iter(index_fields))]
    order = np.argsort(first, kind="stable")
    idx.create_dataset("sorted", data=first[order][None, :], chunks=(1, max(1, min(n, chunk_rows))),
                       maxshape=(None, n))
    idx.create_dataset("indices", data=order.astype(np.uint32)[None, :], chunks=(1, max(1, min(n, chunk_rows))),
                       maxshape=(None, n))
    return grp


def pytables_frames(n=300, seed=0):
    """The frames every PyTables variant holds: an observations table (int
    index, a float block, a bool block, a string data column) and a result
    table multi-indexed by expert coordinates; as write_frame_table's
    keyword arguments."""
    rng = np.random.default_rng(seed)
    obs = dict(
        index_fields={"index": (np.arange(n, dtype=np.int64) * 3, "integer")},
        blocks=[("values_block_0", ["x", "y", "obs"], rng.normal(size=(n, 3))),
                ("values_block_1", ["datetime"], (np.datetime64("2020-03-01", "ns")
                                                  + np.sort(rng.integers(0, 10**15, n)).astype("timedelta64[ns]"))
                 .astype(np.int64)[:, None], "datetime64"),
                ("values_block_2", ["valid", "ok"], (rng.random((n, 2)) > 0.5).astype(np.uint8))],
        data_columns=[("sat", np.array([b"S3A", b"S3B", b"CS2"])[rng.integers(0, 3, n)], "string")],
        bitfields=("values_block_2",),
    )
    m = n // 3
    res = dict(
        index_fields={"x": (rng.normal(size=m).round(3), "float"), "y": (rng.normal(size=m).round(3), "float")},
        blocks=[("values_block_0", ["_dim_0", "lengthscales"],
                 np.stack([np.arange(m) % 2, rng.uniform(1, 2, m)], axis=1))],
    )
    return {"data": obs, "lengthscales": res}


def write_pytables(path, storage, n=300, seed=0):
    import h5py

    with h5py.File(path, "w") as f:
        for name, text in (("CLASS", "GROUP"), ("PYTABLES_FORMAT_VERSION", "2.1"), ("TITLE", ""), ("VERSION", "1.0")):
            _bytes_attr(f, name, text)
        for key, kw in pytables_frames(n, seed).items():
            write_frame_table(f, key, storage=storage, **kw)


def results_store(path, experts, seed=0, libver="earliest", chunk_rows=32):
    """A GPSat results store (PyTables) of ``experts`` ({"x", "y"}): the
    lengthscales (one row per dimension, ``_dim_0``), kernel_variance and
    likelihood_variance of each, in the units the runs store (lengthscales
    over coords_scale), f32-representable so that an f32 run loads them
    exactly; zlib chunks of ``chunk_rows`` rows, the library-version
    bounds ``libver`` (an h5py ``libver``)."""
    import h5py

    rng = np.random.default_rng(seed)
    e = len(experts["x"])
    x, y = np.asarray(experts["x"], float), np.asarray(experts["y"], float)
    ls = rng.uniform(1.0, 8.0, (e, 2)).astype(np.float32).astype(np.float64)
    kv = rng.uniform(0.01, 0.1, e).astype(np.float32).astype(np.float64)
    lv = rng.uniform(1e-3, 1e-2, e).astype(np.float32).astype(np.float64)
    with h5py.File(path, "w", libver=libver) as f:
        _bytes_attr(f, "CLASS", "GROUP")
        write_frame_table(f, "lengthscales", index_fields={"x": (np.repeat(x, 2), "float"),
                                                           "y": (np.repeat(y, 2), "float")},
                          blocks=[("values_block_0", ["_dim_0", "lengthscales"],
                                   np.stack([np.tile([0.0, 1.0], e), ls.reshape(-1)], axis=1))],
                          storage="zlib", chunk_rows=chunk_rows)
        for name, vals in (("kernel_variance", kv), ("likelihood_variance", lv)):
            write_frame_table(f, name, index_fields={"x": (x, "float"), "y": (y, "float")},
                              blocks=[("values_block_0", [name], vals[:, None])], storage="zlib",
                              chunk_rows=chunk_rows)
    return {"lengthscales": ls, "kernel_variance": kv, "likelihood_variance": lv}


# --------------------------------------------------------------------------
# netCDF-4 layout
# --------------------------------------------------------------------------


def _bounds(libver):
    """(low, high) of h5py's library-version bounds for a LIBVER key or an
    h5py libver, as h5f constants."""
    import h5py

    h5f = h5py.h5f
    bound = {"earliest": h5f.LIBVER_EARLIEST, "v108": h5f.LIBVER_V18, "v110": h5f.LIBVER_V110,
             "latest": h5f.LIBVER_LATEST}
    lv = LIBVER.get(libver, libver)
    low, high = lv if isinstance(lv, tuple) else (lv, "latest")
    return bound[low], bound[high]


def create_file(path, libver="earliest", track_order=False, userblock=0, fcpl_fn=None):
    """An h5py File created as ``h5py.File(path, "w", libver=..., track_order=...,
    userblock_size=...)`` creates it, with ``fcpl_fn(fcpl)`` then setting
    what h5py's File does not (the sizes of offsets, the shared-message
    table, the root group's link filters)."""
    import h5py

    h5p = h5py.h5p
    fcpl = h5p.create(h5p.FILE_CREATE)
    if track_order:
        fcpl.set_link_creation_order(h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED)
        fcpl.set_attr_creation_order(h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED)
    if userblock:
        fcpl.set_userblock(userblock)
    if fcpl_fn is not None:
        fcpl_fn(fcpl)
    fapl = h5p.create(h5p.FILE_ACCESS)
    fapl.set_libver_bounds(*_bounds(libver))
    return h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl))


def write_netcdf_variant(path, libver="earliest", track_order=False, layout="contiguous", extra=0, phony=False,
                         cf_time=True, seed=0, userblock=0, extra_attrs=None, fcpl_fn=None):
    """A netCDF-4-layout file as h5py can lay it out: dimension scales x
    (7), y (11) and t (5) with coordinate variables, a [7, 11, 5] float
    variable and a [11, 5] int variable, a string variable over x; the
    library-version bounds and creation order as given (netCDF-C: v1.8,
    tracked); ``layout`` "contiguous", "chunked" (edge chunks: chunks of
    (3, 4, 2)) or "filtered" (those chunks through shuffle, deflate and
    fletcher32); ``extra`` more variables over x, each with
    ``extra_attrs`` attributes (as many as ``extra`` unless given; dense
    links and attributes past 8); ``phony`` a dimension with no coordinate
    variable, as netCDF-C writes it; ``cf_time`` t in "days since" with a
    _FillValue, else plain integers; ``userblock`` bytes of a user block
    before the superblock (0: none); ``fcpl_fn`` as create_file takes it."""
    import h5py

    rng = np.random.default_rng(seed)
    kw = {}
    if layout in ("chunked", "filtered"):
        kw = {"chunks": (3, 4, 2)}
        if layout == "filtered":
            kw.update(compression="gzip", shuffle=True, fletcher32=True)
    if fcpl_fn is None:
        opened = h5py.File(path, "w", libver=LIBVER[libver], track_order=track_order, userblock_size=userblock)
    else:
        opened = create_file(path, libver, track_order, userblock, fcpl_fn)
    with opened as f:
        f.attrs["_NCProperties"] = np.bytes_(b"version=2,netcdf=4.9.2,hdf5=1.14.6")
        f.attrs["title"] = "gpsat fixture"
        x = f.create_dataset("x", data=np.linspace(-1.0, 1.0, 7))
        x.make_scale("x")
        x.attrs["units"] = "m"
        if phony:  # netCDF-C's dimension without a variable: a scale of no data, NAME the phony marker
            y = f.create_dataset("y", shape=(11,), dtype="f4")
            y.make_scale(PHONY_NAME.decode() + "         11")
        else:
            y = f.create_dataset("y", data=np.arange(11, dtype=np.int32) * 10)
            y.make_scale("y")
        t = f.create_dataset("t", data=np.arange(5, dtype=np.int64) * 2 - 1)
        t.make_scale("t")
        if cf_time:
            t.attrs["units"] = "days since 2020-03-01 00:00:00"
            t.attrs["calendar"] = "standard"
            t.attrs["_FillValue"] = np.int64(-1)
        z = f.create_dataset("z", data=rng.normal(size=(7, 11, 5)).astype(np.float32), **kw)
        z.attrs["scale_factor"] = np.float32(2.0)
        z.attrs["add_offset"] = np.float64(0.5)
        for axis, dim in enumerate((x, y, t)):
            z.dims[axis].attach_scale(dim)
        count = f.create_dataset("count", data=rng.integers(-5, 50, (11, 5)).astype(np.int16),
                                 **({"chunks": (4, 2)} if kw else {}))
        count.attrs["_FillValue"] = np.int16(-5)
        count.dims[0].attach_scale(y)
        count.dims[1].attach_scale(t)
        name = f.create_dataset("station", data=np.array([f"st{i}" for i in range(7)], dtype=object),
                                dtype=h5py.string_dtype())
        name.dims[0].attach_scale(x)
        for i in range(extra):
            v = f.create_dataset(f"v{(7 * i) % extra:02d}", data=rng.normal(size=7))
            v.dims[0].attach_scale(x)
            for j in range(extra if extra_attrs is None else extra_attrs):
                v.attrs[f"a{j:02d}"] = np.int64(i * j)


# --------------------------------------------------------------------------
# version-4 layouts (libver "latest"), h5py's lzf filter, committed
# datatypes and a user block
# --------------------------------------------------------------------------

# HDF5's chunk index types (H5D_chunk_index_t) and the extensible array's
# fixed parameters (H5Dearray.c): 4 elements in the index block, data
# blocks of 16 elements and more, pages of 2^10 elements. Its first paged
# data block holds element 4 + 131056 (super block 13: data blocks of 2,048
# elements, two pages each).
INDEX_TYPES = {0: "v1 B-tree", 1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
               5: "v2 B-tree"}
EA_FIRST_PAGED = 4 + 131056
FA_PAGE = 1024
DONT_FILTER_PARTIAL_CHUNKS = 0x0002  # H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS


def _hdf5_call(name, *args):
    """Call a function of the HDF5 library h5py was built on, for what h5py
    does not bind (H5Pset_chunk_opts, H5Dget_chunk_index_type, the
    shared-message table's settings, a group's filters); raises on a
    negative status."""
    import ctypes

    import h5py

    fn = getattr(ctypes.CDLL(h5py.h5p.__file__), name)
    status = fn(*args)
    if status < 0:
        raise RuntimeError(f"{name} failed ({status})")


def chunk_index_type(ds) -> str:
    """The chunk index HDF5 keeps for an h5py dataset (its name in
    INDEX_TYPES)."""
    import ctypes

    out = ctypes.c_int(-1)
    _hdf5_call("H5Dget_chunk_index_type", ctypes.c_int64(ds.id.id), ctypes.byref(out))
    return INDEX_TYPES[out.value]


def _phony_dims(f, sizes):
    """netCDF-C's dimensions without a variable: a scale of no data each,
    NAME its phony marker and the size."""
    out = []
    for i, n in enumerate(sizes):
        d = f.create_dataset(f"dim{i}", shape=(n,), dtype="f4")
        d.make_scale(PHONY_NAME.decode() + f"{n:10d}")
        out.append(d)
    return out


def _variable(f, name, dims, dcpl_fn=None, **kw):
    """A dataset attached to the scales ``dims``. With ``dcpl_fn`` it is made
    through h5py's low-level API: ``filters`` (functions of the creation
    property list, each setting one filter) and then ``dcpl_fn(dcpl)`` set
    what h5py's create_dataset cannot."""
    import h5py

    if dcpl_fn is None:
        ds = f.create_dataset(name, **kw)
    else:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk(kw["chunks"])
        dcpl.set_fill_value(np.array(kw.get("fillvalue", 0), dtype=kw["dtype"]))
        for flt in kw.get("filters", ()):
            flt(dcpl)
        dcpl_fn(dcpl)
        maxshape = tuple(h5py.h5s.UNLIMITED if m is None else m for m in kw.get("maxshape", kw["shape"]))
        space = h5py.h5s.create_simple(kw["shape"], maxshape)
        h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(np.dtype(kw["dtype"])), space, dcpl=dcpl)
        ds = f[name]
    for axis, d in enumerate(dims):
        ds.dims[axis].attach_scale(d)
    return ds


def write_v4_earray(path, n=10_000):
    """An extensible array of ``n`` one-row chunks (secondary blocks past
    element 244): a variable over an unlimited dimension t, its coordinate
    variable contiguous."""
    import h5py

    with h5py.File(path, "w", libver="latest") as f:
        t = f.create_dataset("t", data=np.arange(n, dtype=np.int32) * 3)
        t.make_scale("t")
        v = _variable(f, "v", [t], data=(np.arange(n) % 251 - 125).astype(np.int16), chunks=(1,), maxshape=(None,))
        v.attrs["units"] = "1"


def write_v4_earray_paged(path):
    """Extensible arrays whose chunks reach paged data blocks: [1100, 3]
    variables of one-element chunks whose first dim may grow to 70,000 and
    whose second is unlimited, so that the swizzled index of column c, row r
    is 70,000 c + r; column 2 reaches super block 13 (paged data blocks),
    rows 0-275 in one page, the rest of the column (another page) written
    at one row only or not at all. "p" unfiltered, "q" through deflate;
    fill values where nothing was written."""
    import h5py

    rng = np.random.default_rng(7)
    with h5py.File(path, "w", libver="latest") as f:
        dims = _phony_dims(f, (1100, 3))
        kw = dict(shape=(1100, 3), maxshape=(70_000, None), chunks=(1, 1), dtype="f4", fillvalue=-2.5)
        p = _variable(f, "p", dims, **kw)
        p[:276, 2] = rng.normal(size=276)
        p[1000, 2] = 9.0  # the second page of the same data block
        p[500:600, 1] = 3.0
        p[:10, 0] = np.arange(10)
        q = _variable(f, "q", dims, compression="gzip", **kw)
        q[:276, 2] = rng.normal(size=276)
        q[700, 1] = 5.0
        q[:3, 0] = 6.0


def write_v4_farray(path):
    """Fixed arrays: "f", [40, 30] of one-element chunks (1,200 chunks: two
    pages of 1,024), rows 0-32 written but for two chunks, so that the
    second page was never written; "g" through shuffle and deflate in
    chunks of (7, 7), its partial edge chunks stored unfiltered
    (H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS)."""
    import ctypes

    import h5py

    rng = np.random.default_rng(8)
    with h5py.File(path, "w", libver="latest") as f:
        y = f.create_dataset("y", data=np.arange(40, dtype=np.float64) * 0.5)
        y.make_scale("y")
        x = f.create_dataset("x", data=np.arange(30, dtype=np.int16))
        x.make_scale("x")
        fv = _variable(f, "f", [y, x], shape=(40, 30), chunks=(1, 1), dtype="f4", fillvalue=-1.0)
        vals = rng.normal(size=(33, 30)).astype(np.float32)
        fv[:5], fv[6:32] = vals[:5], vals[6:32]  # chunks (5, 5) and (32, 29) never written
        fv[5, :5], fv[5, 6:], fv[32, :29] = vals[5, :5], vals[5, 6:], vals[32, :29]
        g = _variable(f, "g", [y, x], dcpl_fn=lambda d: _hdf5_call(
            "H5Pset_chunk_opts", ctypes.c_int64(d.id), ctypes.c_uint(DONT_FILTER_PARTIAL_CHUNKS)),
            shape=(40, 30), chunks=(7, 7), dtype="f8", filters=(lambda d: d.set_shuffle(), lambda d: d.set_deflate(4)))
        g[...] = np.round(rng.normal(size=(40, 30)), 2)


def write_v4_indexes(path):
    """The other three indexes over dims y (10) and x (12): a single chunk
    unfiltered ("s1") and through deflate ("s2", its filtered size and mask
    in the layout message), implicit chunks allocated early ("im": chunks
    of (3, 4), the dims' maximum (12, 14)), and version-2 B-trees of chunk
    records over two unlimited dims, of type 10 ("b10", one-element chunks)
    and 11 ("b11", deflate over (3, 5), one chunk never written)."""
    import h5py

    rng = np.random.default_rng(9)
    with h5py.File(path, "w", libver="latest") as f:
        y = f.create_dataset("y", data=np.arange(10, dtype=np.float32))
        y.make_scale("y")
        x = f.create_dataset("x", data=np.arange(12, dtype=np.float32) * 10)
        x.make_scale("x")
        data = rng.integers(-1000, 1000, (10, 12)).astype(np.int32)
        _variable(f, "s1", [y, x], data=data, chunks=(10, 12))
        _variable(f, "s2", [y, x], data=data * 2, chunks=(10, 12), compression="gzip")
        im = _variable(f, "im", [y, x], dcpl_fn=lambda d: d.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY),
                       shape=(10, 12), maxshape=(12, 14), chunks=(3, 4), dtype="i4", fillvalue=-9)
        im[:9] = data[:9] * 3
        _variable(f, "b10", [y, x], data=data * 4, chunks=(1, 1), maxshape=(None, None))
        b11 = _variable(f, "b11", [y, x], shape=(10, 12), chunks=(3, 5), maxshape=(None, None), dtype="i4",
                        compression="gzip", shuffle=True, fillvalue=7)
        b11[:9] = data[:9] * 5
        b11[9, :10] = data[9, :10] * 5  # the chunk at (9, 10) never written


def write_v4_lzf(path):
    """h5py's lzf filter on fixed-array chunks: "z", [48, 40] f8 of (16, 8)
    chunks, and "u", uint8 of the same chunks, zeros but for one chunk of
    random bytes, which LZF cannot shrink and HDF5 stores raw, its mask
    bit set."""
    import h5py

    rng = np.random.default_rng(10)
    with h5py.File(path, "w", libver="latest") as f:
        y = f.create_dataset("y", data=np.arange(48, dtype=np.float64))
        y.make_scale("y")
        x = f.create_dataset("x", data=np.arange(40, dtype=np.float64))
        x.make_scale("x")
        z = np.round(np.sin(np.arange(48)[:, None] / 5.0) * np.cos(np.arange(40)[None, :] / 7.0), 3)
        _variable(f, "z", [y, x], data=z, chunks=(16, 8), compression="lzf")
        u = np.zeros((48, 40), np.uint8)
        u[16:32, 8:16] = rng.integers(0, 256, (16, 8))
        _variable(f, "u", [y, x], data=u, chunks=(16, 8), compression="lzf")


def write_committed_types(path):
    """netCDF-C's user-defined types as it commits them in the root group:
    an enum "flag_t", a compound "obs_t" and a vlen "ragged_t"; a variable
    of each over x, and attributes of the enum and the compound. netCDF-C's
    bounds (v1.8, creation order tracked)."""
    import h5py

    with h5py.File(path, "w", libver=LIBVER["v108"], track_order=True) as f:
        f.attrs["_NCProperties"] = np.bytes_(b"version=2,netcdf=4.9.2,hdf5=1.14.6")
        x = f.create_dataset("x", data=np.linspace(0.0, 3.0, 7))
        x.make_scale("x")
        f["flag_t"] = h5py.enum_dtype({"CLEAR": 0, "CLOUD": 1, "ICE": 2}, "i1")
        f["obs_t"] = np.dtype([("value", "<f8"), ("count", "<i4")])
        f["ragged_t"] = h5py.vlen_dtype(np.dtype("<i2"))
        flag = _variable(f, "flag", [x], data=np.array([0, 1, 2, 2, 1, 0, 1], "i1"), dtype=f["flag_t"])
        flag.attrs.create("valid_flags", np.array([0, 2], "i1"), dtype=f["flag_t"])
        flag.attrs.create("summary", np.array([(1.5, 3)], f["obs_t"].dtype), dtype=f["obs_t"])
        obs = np.zeros(7, f["obs_t"].dtype)
        obs["value"], obs["count"] = np.arange(7) / 4.0, np.arange(7) * 2
        _variable(f, "obs", [x], data=obs, dtype=f["obs_t"])
        ragged = _variable(f, "ragged", [x], shape=(7,), dtype=f["ragged_t"])
        for i in range(7):
            ragged[i] = np.arange(i, dtype=np.int16)
        f.create_dataset("count", data=np.arange(7, dtype=np.int32) * 3).dims[0].attach_scale(x)


# --------------------------------------------------------------------------
# what the codec read last: the shared-message table, filtered fractal
# heaps, 4-byte offsets, external and virtual storage, region references
# --------------------------------------------------------------------------

# every message type HDF5 shares (H5O_SHMESG_*_FLAG: bit t for message type t)
SHARED_TYPES = {"dataspace": 0x0002, "datatype": 0x0008, "fill": 0x0020, "filters": 0x0800, "attribute": 0x1000}


def shared_table(fcpl, index="list", min_size=0) -> None:
    """Share every message type HDF5 can share through the shared-message
    table of ``fcpl``, from ``min_size`` bytes up: in one index, kept a
    list ("list") or a version-2 B-tree from its first message ("btree"),
    or in one index per type ("per_type")."""
    import ctypes

    fid = ctypes.c_int64(fcpl.id)
    groups = [[flag] for flag in SHARED_TYPES.values()] if index == "per_type" else [list(SHARED_TYPES.values())]
    _hdf5_call("H5Pset_shared_mesg_nindexes", fid, ctypes.c_uint(len(groups)))
    for i, flags in enumerate(groups):
        _hdf5_call("H5Pset_shared_mesg_index", fid, ctypes.c_uint(i), ctypes.c_uint(sum(flags)),
                   ctypes.c_uint(min_size))
    if index == "btree":  # lists of no message: a B-tree from the first
        _hdf5_call("H5Pset_shared_mesg_phase_change", fid, ctypes.c_uint(0), ctypes.c_uint(0))


def link_filters(gcpl, kind="deflate") -> None:
    """The filters a group created with ``gcpl`` (a file's: its root)
    sends its dense links' fractal heap through: deflate, or deflate and
    fletcher32 (HDF5 refuses shuffle on a group)."""
    import ctypes

    gid = ctypes.c_int64(gcpl.id)
    _hdf5_call("H5Pset_deflate", gid, ctypes.c_uint(6))
    if kind != "deflate":
        _hdf5_call("H5Pset_fletcher32", gid)


def write_external(path, raw_name):
    """A netCDF-shaped file whose variables lie in an external file
    ``raw_name`` (named as given, so relative to the working directory
    where it is relative): x (6) and y (5) scales, "z" [6, 5] f4 in two
    slots of ``raw_name`` past an offset, "count" [5] i2 in a third, the
    rest of the file left as HDF5 leaves it."""
    import h5py

    rng = np.random.default_rng(12)
    with h5py.File(path, "w", libver=LIBVER["v108"], track_order=True) as f:
        x = f.create_dataset("x", data=np.arange(6, dtype=np.float64))
        x.make_scale("x")
        y = f.create_dataset("y", data=np.arange(5, dtype=np.int32) * 10)
        y.make_scale("y")
        z = f.create_dataset("z", shape=(6, 5), dtype="f4", external=[(raw_name, 64, 48), (raw_name, 160, 72)])
        z[...] = rng.normal(size=(6, 5)).astype(np.float32)
        z.attrs["units"] = "m"
        count = f.create_dataset("count", shape=(5,), dtype="i2", external=[(raw_name, 256, 10)])
        count[...] = np.arange(5, dtype=np.int16) * 3 - 4
        for axis, dim in enumerate((x, y)):
            z.dims[axis].attach_scale(dim)
        count.dims[0].attach_scale(y)


def write_virtual(path, source_name):
    """A netCDF-shaped file whose variables are virtual: x (12) and y (5)
    scales, "local" [12] stored in the file, "v" [12] f8 mapped from the
    source file ``source_name`` (a strided hyperslab of its "a"), from
    "local" in the same file (".") and from a file that does not exist
    (fill -1.0), "w" [12, 5] i4 a 2-D block and two blocks together (an
    irregular hyperslab; HDF5 takes no point selection in a mapping) of the
    source's "b" and a dataset the source does not hold (fill 7).
    ``source_name`` is written beside ``path``; the mappings name it
    relative to it."""
    import h5py

    src = Path(path).parent / source_name
    with h5py.File(src, "w") as s:
        s["a"] = np.arange(20, dtype=np.float64) * 0.5
        s["b"] = np.arange(24, dtype=np.int32).reshape(4, 6) - 5
    with h5py.File(path, "w", track_order=True) as f:  # a virtual layout needs the bounds to reach v1.10
        x = f.create_dataset("x", data=np.arange(12, dtype=np.float64))
        x.make_scale("x")
        y = f.create_dataset("y", data=np.arange(5, dtype=np.int32))
        y.make_scale("y")
        local = f.create_dataset("local", data=np.arange(12, dtype=np.float64) + 100)
        v = h5py.VirtualLayout(shape=(12,), dtype="f8")
        v[0:6] = h5py.VirtualSource(source_name, "a", shape=(20,))[0:12:2]
        v[6:10] = h5py.VirtualSource(".", "local", shape=(12,))[2:6]
        v[10:12] = h5py.VirtualSource("missing_source.h5", "a", shape=(2,))
        f.create_virtual_dataset("v", v, fillvalue=-1.0)
        w = h5py.VirtualLayout(shape=(12, 5), dtype="i4")
        w[2:6, 1:4] = h5py.VirtualSource(source_name, "b", shape=(4, 6))[0:4, 2:5]
        w[8:9, 0:5] = h5py.VirtualSource(source_name, "no_such_dataset", shape=(1, 5))
        f.create_virtual_dataset("w", w, fillvalue=7)
        _irregular_mapping(f["w"], src, "b", [((3, 4), (1, 2)), ((0, 0), (1, 1))], [((10, 0), (1, 2)), ((11, 3), (1, 1))])
        for name, dims in (("local", [x]), ("v", [x]), ("w", [x, y])):
            for axis, d in enumerate(dims):
                f[name].dims[axis].attach_scale(d)


def _irregular_mapping(ds, src_path, src_name, src_blocks, blocks, file_name=None):
    """Re-create the virtual dataset ``ds`` with one mapping more, of
    irregular hyperslabs (h5py's VirtualLayout takes one slice per dim):
    the union of ``src_blocks`` ((start, count) each) of ``src_name`` in
    ``src_path`` (named ``file_name``, by default its file name) to that
    of ``blocks``."""
    import h5py

    def union(space, parts):
        space.select_none()
        for start, count in parts:
            space.select_hyperslab(start, count, op=h5py.h5s.SELECT_OR)
        return space

    f, name = ds.file, ds.name
    dcpl = ds.id.get_create_plist()
    vspace = union(h5py.h5s.create_simple(ds.shape), blocks)
    with h5py.File(src_path, "r") as s:
        sspace = union(h5py.h5s.create_simple(s[src_name].shape), src_blocks)
    dcpl.set_virtual(vspace, (file_name or Path(src_path).name).encode(), f"/{src_name}".encode(), sspace)
    dtype, attrs = ds.dtype, dict(ds.attrs)
    del f[name]
    h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(dtype), h5py.h5s.create_simple(ds.shape), dcpl=dcpl)
    for k, v in attrs.items():
        f[name].attrs[k] = v


def write_region_refs(path, libver="earliest"):
    """Region references (a dataset "refs" of them, and an attribute) into
    "x" [4, 6] f8 and "y" [30] i4: a block, a strided hyperslab, two
    hyperslabs together, points, everything and nothing, as h5py makes
    them; ``libver`` sets their selections' encodings (earliest: version
    1; latest: version 3 hyperslabs and version 2 points)."""
    import h5py

    with h5py.File(path, "w", libver=LIBVER.get(libver, libver)) as f:
        x = f.create_dataset("x", data=np.arange(24.0).reshape(4, 6) / 4)
        y = f.create_dataset("y", data=np.arange(30, dtype=np.int32) * 3 - 7)

        def made(ds, select):
            sid = ds.id.get_space()
            select(sid)
            return h5py.h5r.create(ds.id, b".", h5py.h5r.DATASET_REGION, sid)

        two = made(x, lambda s: (s.select_hyperslab((0, 0), (2, 2)),
                                 s.select_hyperslab((2, 3), (1, 3), op=h5py.h5s.SELECT_OR)))
        refs = [x.regionref[1:3, 2:5], y.regionref[2:29:4], two,
                made(y, lambda s: s.select_elements(np.array([[17], [3], [25]], dtype=np.uint64))),
                made(x, lambda s: s.select_elements(np.array([[3, 1], [0, 0], [2, 5]], dtype=np.uint64))),
                x.regionref[...], made(y, lambda s: s.select_none()), x.regionref[::3, 1::2]]
        r = f.create_dataset("refs", (len(refs),), dtype=h5py.regionref_dtype)
        for i, ref in enumerate(refs):
            r[i] = ref
        x.attrs.create("ref", refs[1], dtype=h5py.regionref_dtype)


NETCDF_VARIANTS = {
    "nc_earliest": dict(),
    "nc_netcdf_c": dict(libver="v108", track_order=True),
    "nc_earliest_v108_tracked": dict(libver="earliest_v108", track_order=True),
    "nc_chunked_filtered": dict(libver="v108", track_order=True, layout="filtered"),
    "nc_chunked": dict(layout="chunked"),
    "nc_phony": dict(libver="v108", track_order=True, phony=True),
    "nc_dense": dict(libver="v108", track_order=True, extra=20),
}
PYTABLES_VARIANTS = ("plain", "zlib", "blosc", "bzip2")


# --------------------------------------------------------------------------
# results stores as the JAX package writes them (its TableStore over h5py)
# --------------------------------------------------------------------------

# the filters of a store's columns, as h5py's create_dataset takes them
COLUMN_FILTERS = {None: {}, "gzip": dict(compression="gzip", shuffle=True), "fletcher32": dict(fletcher32=True),
                  "lzf": dict(compression="lzf")}
# filters h5py lacks, laid over a store's numeric columns by refilter_store:
# (filter id, client data for the element size and the chunk's rows)
DIRECT_FILTERS = {"blosc": (BLOSC_ID, lambda size, rows: (2, 2, size, size * rows, 5, 1, BLOSC_LZ4)),
                  "bzip2": (BZIP2_ID, lambda size, rows: (9,))}


def create_h5py_store(path, libver="earliest", track_order=False, istore_k=None, sym_k=None) -> None:
    """An empty HDF5 file as h5py creates one at ``libver`` (a LIBVER key or
    an h5py libver): the root group tracking the creation order of its
    links and attributes where ``track_order``; H5Pset_istore_k and
    H5Pset_sym_k where given (at libver "earliest" a chunk K makes a
    version-1 superblock; at later bounds the K values go in the superblock
    extension). The JAX TableStore then opens it with h5py's default
    bounds, as a user's later sessions do."""
    import ctypes

    import h5py

    h5f, h5p = h5py.h5f, h5py.h5p
    fcpl = h5p.create(h5p.FILE_CREATE)
    if track_order:
        fcpl.set_link_creation_order(h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED)
        fcpl.set_attr_creation_order(h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED)
    if istore_k:
        _hdf5_call("H5Pset_istore_k", ctypes.c_int64(fcpl.id), ctypes.c_uint(istore_k))
    if sym_k:  # (the group B-trees' K, the symbol-table nodes' K)
        _hdf5_call("H5Pset_sym_k", ctypes.c_int64(fcpl.id), ctypes.c_uint(sym_k[0]), ctypes.c_uint(sym_k[1]))
    fapl = h5p.create(h5p.FILE_ACCESS)
    fapl.set_libver_bounds(*_bounds(libver))
    h5f.create(str(path).encode(), h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl).close()


@contextlib.contextmanager
def column_filters(kind):
    """While the block runs, every dataset h5py creates goes through the
    filters COLUMN_FILTERS[kind]: how the JAX TableStore's columns get them
    (but fletcher32, which HDF5 does not apply to variable-length strings)."""
    import h5py

    real, extra = h5py.Group.create_dataset, COLUMN_FILTERS[kind]

    def create(self, name, *args, **kw):
        vlen = np.asarray(kw.get("data", ())).dtype == object
        return real(self, name, *args, **kw, **({} if vlen and kind == "fletcher32" else extra))

    h5py.Group.create_dataset = create
    try:
        yield
    finally:
        h5py.Group.create_dataset = real


def refilter_store(path, kind) -> None:
    """Lay DIRECT_FILTERS[kind] over every numeric column of the store at
    ``path``: each is read, deleted and written anew with the filter in its
    pipeline (optional, as PyTables sets it) and its chunks encoded here
    (blosc by the port's own encoder, bzip2 by ``bz2``) and written by
    write_direct_chunk, with its attributes; string columns stay as they
    are."""
    import h5py
    from h5py import h5d, h5p, h5s, h5t

    from gpsat_tpu_torch.data.blosc import blosc_encode

    fid, client = DIRECT_FILTERS[kind]
    with h5py.File(path, "a") as f:
        for table in list(f):
            grp = f[table]
            for name in list(grp):
                ds = grp[name]
                if ds.dtype.kind not in "biuf" or ds.chunks is None:
                    continue
                data, attrs, rows = ds[()], dict(ds.attrs), ds.chunks[0]
                del grp[name]
                dcpl = h5p.create(h5p.DATASET_CREATE)
                dcpl.set_chunk((rows,))
                dcpl.set_filter(fid, h5py.h5z.FLAG_OPTIONAL, client(data.dtype.itemsize, rows))
                dsid = h5d.create(grp.id, name.encode(), h5t.py_create(data.dtype),
                                  h5s.create_simple((len(data),), (h5s.UNLIMITED,)), dcpl=dcpl)
                for lo in range(0, len(data), rows):
                    chunk = np.zeros(rows, data.dtype)
                    part = data[lo:lo + rows]
                    chunk[:len(part)] = part
                    raw = chunk.tobytes()
                    blob = blosc_encode(raw, data.dtype.itemsize, cname="lz4", shuffle=1) if kind == "blosc" \
                        else bz2.compress(raw, 9)
                    dsid.write_direct_chunk((lo,), blob, filter_mask=0)
                for k, v in attrs.items():
                    grp[name].attrs[k] = v


# chip_smoke.py phase 17 (h)'s stores: file -> (libver, column filters,
# create_h5py_store's settings); the v1.8 store's chunk B-trees of K = 8 (a K
# values message in the superblock extension) keep it small
RESTART_STORES = {"restart_latest_gzip.h5": ("latest", "gzip", {}),
                  "restart_v108.h5": ("v108", None, {"istore_k": 8})}
# the tables a run writes per expert, in the order it appends them
PER_EXPERT = ("run_details", "preds", "lengthscales", "kernel_variance", "likelihood_variance")


def write_restart_stores(out: Path) -> None:
    """The first half of chip_smoke.restart_oi's run in each of
    RESTART_STORES, written by the JAX TableStore over h5py as a run that
    stopped halfway leaves its store: the config and every expert location
    (written when the run starts), then each per-expert table's rows of the
    first half of the experts in two appends (a third, then the rest, so
    that each column's last chunk is partly filled). The rows come from the
    port's run of all the experts on the CPU, one thread."""
    import torch

    import chip_smoke as cs
    from gpsat_tpu.data.store import TableStore as JStore
    from gpsat_tpu_torch.data.store import TableStore as TStore

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            full = Path(tmp) / "full.h5"
            cs.restart_oi(full, "cpu")
            with TStore(str(full), mode="r") as s:
                tables = {t: s.select(t) for t in s.keys()}
    finally:
        torch.set_num_threads(threads)
    rd = tables["run_details"]
    first = rd.index[:len(rd) // 2]
    for name, (libver, filters, settings) in RESTART_STORES.items():
        path = out / name
        create_h5py_store(path, libver, **settings)
        with column_filters(filters), JStore(str(path)) as store:
            store.append("oi_config", tables["oi_config"])
            store.append("expert_locs", tables["expert_locs"])
            for t in PER_EXPERT:
                df = tables[t][tables[t].index.isin(first)]
                cut = max(1, len(df) // 3)
                store.append(t, df.iloc[:cut])
                store.append(t, df.iloc[cut:])


# --------------------------------------------------------------------------
# the fixtures and their expected frames
# --------------------------------------------------------------------------


V4_RESULTS = "v4_results_store.h5"
# file -> (writer, the variables its expected frame reads; None: all)
V4_NETCDF = {
    "v4_earray.nc": (write_v4_earray, None),
    "v4_earray_paged.nc": (write_v4_earray_paged, None),
    "v4_farray.nc": (write_v4_farray, None),
    "v4_indexes.nc": (write_v4_indexes, None),
    "v4_lzf.nc": (write_v4_lzf, None),
    "nc_committed_types.nc": (write_committed_types, ["flag", "count"]),
    "nc_user_block.nc": (lambda path: write_netcdf_variant(path, userblock=512), None),
}


# what the codec read last, each read through the JAX package's readers:
# file -> (writer of the file (and of what it names beside it), the reader
# of its expected frame: "netcdf"; "netcdf_here", read from its own
# directory, where its relative external names lead; or "regions",
# chip_smoke.region_frame of its region references)
CODEC_FIXTURES = {
    "nc_shared_messages.nc": (lambda path: write_netcdf_variant(
        path, libver="v108", layout="filtered", extra=9,
        fcpl_fn=lambda p: shared_table(p, "list")), "netcdf"),
    "nc_filtered_heap.nc": (lambda path: write_netcdf_variant(
        path, libver="v108", track_order=True, extra=30, extra_attrs=1, fcpl_fn=link_filters), "netcdf"),
    "nc_four_byte.nc": (lambda path: write_netcdf_variant(
        path, libver="v108", layout="chunked", extra=9,
        fcpl_fn=lambda p: p.set_sizes(4, 4)), "netcdf"),
    "nc_external.nc": (lambda path: write_external(path, "nc_external.raw"), "netcdf_here"),
    "nc_virtual.nc": (lambda path: write_virtual(path, "nc_virtual_src.h5"), "netcdf"),
    "region_refs.h5": (lambda path: write_region_refs(path, "latest"), "regions"),
}


def write_vds_obs(path) -> None:
    """chip_smoke.py phase 17 (i)'s observations file: phase 7's rows
    (``pipeline_inputs``) as a netCDF file whose variables ("index", a
    dimension scale, then x, y, z; the dtypes of ``cli_inputs``' netCDF
    file) are virtual, each the same variable of ``vds_granules``' files,
    named relative to it. The granules are not written: the card writes
    them with the port's own writer."""
    import h5py

    import chip_smoke as cs

    obs, _, _ = cs.pipeline_inputs()
    n = len(obs["x"])
    with h5py.File(path, "w") as f:
        for name, dtype in (("index", "<i8"), ("x", "<f8"), ("y", "<f8"), ("z", "<f8")):
            layout = h5py.VirtualLayout(shape=(n,), dtype=dtype)
            for granule, lo, hi in cs.vds_granules(n):
                layout[lo:hi] = h5py.VirtualSource(granule, f"/{name}", shape=(hi - lo,))
            f.create_virtual_dataset(name, layout)
        f["index"].make_scale("index")
        for name in ("x", "y", "z"):
            f[name].dims[0].attach_scale(f["index"])


def check_structure(path: Path) -> None:
    """Each fixture of the later formats holds what it is there for: the
    chunk index of each dataset (HDF5's own word on it), the structures'
    signatures, paged blocks, an lzf chunk stored raw, committed types, a
    user block."""
    import h5py

    raw = path.read_bytes()
    with h5py.File(path, "r") as f:
        index = {k: chunk_index_type(f[k]) for k in f if isinstance(f[k], h5py.Dataset) and f[k].chunks}

        def has(*sigs):
            for sig in sigs:
                assert sig in raw, f"{path.name}: no {sig!r}"

        if path.name == V4_RESULTS:
            tables = [f[t]["table"] for t in ("lengthscales", "kernel_variance", "likelihood_variance")]
            assert all(chunk_index_type(t) == "extensible array" for t in tables), path.name
            assert all(t.id.get_num_chunks() > 4 for t in tables), "the tables' chunks end in the index block"
            has(b"EAHD", b"EAIB", b"EADB")
        elif path.name == "v4_earray.nc":
            assert index == {"v": "extensible array"} and f["v"].id.get_num_chunks() == 10_000, index
            has(b"EASB", b"EADB")
        elif path.name == "v4_earray_paged.nc":
            assert index == {"p": "extensible array", "q": "extensible array"}, index
            for k in index:
                ds = f[k].id
                offsets = []  # one walk of the index (get_chunk_info(i) walks it again for every i)
                ds.chunk_iter(lambda info: offsets.append(info.chunk_offset))
                assert max(c * 70_000 + r for r, c in offsets) >= EA_FIRST_PAGED, f"{k}: no paged data block"
            has(b"EASB")
        elif path.name == "v4_farray.nc":
            assert index == {"f": "fixed array", "g": "fixed array"}, index
            assert np.prod(f["f"].shape) > FA_PAGE and f["f"].id.get_num_chunks() < FA_PAGE, "f: not paged"
            mask, blob = f["g"].id.read_direct_chunk((35, 28))  # a partial edge chunk, stored raw
            assert mask == 0 and len(blob) == 7 * 7 * 8, (mask, len(blob))
            has(b"FAHD", b"FADB")
        elif path.name == "v4_indexes.nc":
            assert index == {"s1": "single chunk", "s2": "single chunk", "im": "implicit", "b10": "v2 B-tree",
                             "b11": "v2 B-tree"}, index
            has(b"BTHD", b"BTLF")
        elif path.name == "v4_lzf.nc":
            assert index == {"z": "fixed array", "u": "fixed array"}, index
            assert f["u"].id.get_create_plist().get_filter(0)[0] == 32000
            masks = [f["u"].id.get_chunk_info(i).filter_mask for i in range(f["u"].id.get_num_chunks())]
            assert sorted(masks) == [0] * (len(masks) - 1) + [1], masks
        elif path.name == "nc_committed_types.nc":
            assert all(isinstance(f[t], h5py.Datatype) for t in ("flag_t", "obs_t", "ragged_t"))
            assert all(f[k].id.get_type().committed() for k in ("flag", "obs", "ragged"))
        elif path.name == "nc_user_block.nc":
            assert f.userblock_size == 512 and raw[512:520] == b"\x89HDF\r\n\x1a\n"
        elif path.name == "nc_shared_messages.nc":  # the table; past 50 messages its index is a B-tree
            has(b"SMTB", b"BTHD")
        elif path.name == "nc_filtered_heap.nc":  # the root's links in a heap with a pipeline, past one block
            heaps = [i for i in range(len(raw) - 9) if raw.startswith(b"FRHP", i)]
            assert any(int.from_bytes(raw[i + 7:i + 9], "little") for i in heaps), "no fractal heap has filters"
            has(b"FHIB")
        elif path.name == "nc_four_byte.nc":
            assert raw[8] == 2 and raw[9:11] == b"\x04\x04", raw[8:11]
        elif path.name == "nc_external.nc":
            assert [f[k].id.get_create_plist().get_external_count() for k in ("z", "count")] == [2, 1]
        elif path.name == "nc_virtual.nc":
            assert [len(f[k].virtual_sources()) for k in ("v", "w")] == [3, 3]
        elif path.name == "region_refs.h5":
            assert f["refs"].dtype == h5py.regionref_dtype and raw[8] == 3
        elif path.name == "vds_obs.nc":
            import chip_smoke as cs

            granules = {g for g, _, _ in cs.vds_granules(len(f["x"]))}
            assert all(len(f[k].virtual_sources()) == len(granules) for k in ("index", "x", "y", "z"))
            assert {s.file_name for k in f for s in f[k].virtual_sources()} == granules
        elif path.name in RESTART_STORES:  # version-2 headers throughout, the columns as asked
            libver, filters, settings = RESTART_STORES[path.name]
            assert raw[8] == (3 if libver == "latest" else 2), raw[8]
            if settings:  # the chunk K from the K values message in the superblock extension
                from gpsat_tpu_torch.data import hdf5

                with hdf5.File(path, "r") as c:
                    assert c._chunk_k == settings["istore_k"], c._chunk_k
            cols = [f[t][c] for t in f for c in f[t]]
            assert {c.compression for c in cols} == {COLUMN_FILTERS[filters].get("compression")}
            want = {"latest": "extensible array", "v108": "v1 B-tree"}[libver]
            assert {chunk_index_type(c) for c in cols} == {want}
            assert all(len(c) % c.chunks[0] for c in f["preds"].values()), "the last chunks are full"
        else:
            raise ValueError(f"no structure to check in {path.name}")


def frame_arrays(df):
    """A frame as (meta, arrays): each column and index level an array
    (strings as unicode), with the dtypes and names to check it by."""
    cols, arrays = [], {}
    for j, c in enumerate(df.columns):
        vals = df[c].to_numpy()
        if vals.dtype.metadata:  # an enum's members: npz keeps no dtype metadata
            vals = vals.astype(np.dtype(vals.dtype.str))
        kind = "str" if vals.dtype == object else "array"
        arrays[f"c{j}"] = vals.astype("U") if kind == "str" else vals
        cols.append([str(c), str(df[c].dtype), kind])
    levels = []
    for k in range(df.index.nlevels):
        vals = df.index.get_level_values(k).to_numpy()
        kind = "str" if vals.dtype == object else "array"
        arrays[f"i{k}"] = vals.astype("U") if kind == "str" else vals
        levels.append([df.index.names[k], str(vals.dtype), kind])
    return {"columns": cols, "index": levels, "multi": df.index.nlevels > 1}, arrays


def make(out: Path) -> None:
    """Every fixture with an expected frame, and expected.npz, into ``out``."""
    import h5py

    import chip_smoke as cs
    from gpsat_tpu.data import netcdf as JN
    from gpsat_tpu.data import pytables_compat as JPT

    out.mkdir(parents=True, exist_ok=True)
    entries, arrays = [], {}

    def expect(file, reader, key, df, **extra):
        meta, arrs = frame_arrays(df)
        i = len(entries)
        entries.append({"file": file, "reader": reader, "key": key, **extra, **meta})
        arrays.update({f"{i}/{k}": v for k, v in arrs.items()})

    for storage in PYTABLES_VARIANTS:
        name = f"pytables_{storage}.h5"
        write_pytables(out / name, storage)
        # h5py has neither blosc nor bzip2: the JAX reader reads the same frames stored plainly
        ref = out / name if storage in ("plain", "zlib") else out / "pytables_plain.h5"
        for key in ("data", "lengthscales"):
            expect(name, "pytables", key, JPT.read_table(str(ref), key))
    _, experts, _ = cs.pipeline_inputs()
    first = {c: experts[c][:cs.FORMATS_EXPERTS] for c in ("x", "y")}
    results_store(out / "results_store.h5", first)
    for key in ("lengthscales", "kernel_variance", "likelihood_variance"):
        expect("results_store.h5", "pytables", key, JPT.read_table(str(out / "results_store.h5"), key))
    for name, kw in NETCDF_VARIANTS.items():
        write_netcdf_variant(out / f"{name}.nc", **kw)
        expect(f"{name}.nc", "netcdf", None, JN.read_netcdf(str(out / f"{name}.nc")))
    # the version-4 set, lzf, committed datatypes and a user block
    results_store(out / V4_RESULTS, first, libver="latest", chunk_rows=2)
    for key in ("lengthscales", "kernel_variance", "likelihood_variance"):
        expect(V4_RESULTS, "pytables", key, JPT.read_table(str(out / V4_RESULTS), key))
    for name, (write, variables) in V4_NETCDF.items():
        write(out / name)
        kw = {"variables": variables} if variables else {}
        expect(name, "netcdf", None, JN.read_netcdf(str(out / name), **kw), **kw)
    for name, (write, reader) in CODEC_FIXTURES.items():
        if reader == "regions":
            write(out / name)
            with h5py.File(out / name, "r") as f:
                expect(name, "regions", "refs", cs.region_frame(f, "refs"))
        elif reader == "netcdf_here":
            with contextlib.chdir(out):
                write(name)
                expect(name, "netcdf", None, JN.read_netcdf(name), chdir=True)
        else:
            write(out / name)
            expect(name, "netcdf", None, JN.read_netcdf(str(out / name)))
    write_vds_obs(out / cs.FORMATS_VDS)
    for name in (V4_RESULTS, *V4_NETCDF, *CODEC_FIXTURES, cs.FORMATS_VDS):
        check_structure(out / name)
    np.savez_compressed(out / "expected.npz", meta=np.array(json.dumps(entries)), **arrays)
    print(f"wrote {len(entries)} expected frames to {out}")


def write_manifest(out: Path) -> None:
    """MANIFEST.txt: the files in ``out`` and how the stand-ins differ."""
    import h5py

    files = sorted(p.name for p in out.iterdir() if p.suffix in (".h5", ".nc", ".raw"))
    manifest = [
        "HDF5 fixtures of the port's codec (tools/make_hdf5_fixtures.py; written by h5py "
        f"{h5py.__version__}, HDF5 {h5py.version.hdf5_version}).",
        "expected.npz holds each file's frame as the JAX package's h5py readers give it (not the restart_*",
        "stores': their rows come from a fit on the CPU, whose last bits depend on the CPU; chip_smoke.py",
        "phase 17 (h) holds them to themselves before and after a restart).",
        "",
        "Files:",
        *[f"  {p} ({(out / p).stat().st_size} bytes)" for p in files],
        "",
        "Stand-ins: h5py wrote every file. pytables_*.h5, results_store.h5 and v4_results_store.h5 stand in",
        "for PyTables' files, nc_*.nc and v4_*.nc for netCDF-C's; restart_latest_gzip.h5 and restart_v108.h5",
        "are what the JAX package's TableStore itself writes through h5py (the first half of",
        "chip_smoke.restart_oi's run, at libver \"latest\" with deflate+shuffle columns and at \"v108\" with the",
        "chunk B-trees' K of 8 in the superblock extension), not stand-ins.",
        "",
        "What h5py could not lay out the way PyTables or netCDF-C would:",
        "- PyTables writes its string attributes as its own fixed-length types and pickles with protocol 0;",
        "  here they are h5py's null-padded strings and opaque pickles (as tests/test_pytables_compat.py).",
        "- The blosc and bzip2 chunks are written whole by write_direct_chunk (h5py has neither filter), the",
        "  blosc frames by the port's own encoder (data/blosc.py), not c-blosc; their expected frames are",
        "  the JAX reader's of pytables_plain.h5, which holds the same rows.",
        "- The _i_table index is a stub: one group with the sorted values and their row numbers, not",
        "  PyTables' full index (ranges, bounds, the light-weight sorted/indices pairs).",
        "- netCDF-C's _Netcdf4Dimid / _Netcdf4Coordinates attributes and its own fill-value messages are not",
        "  written; a phony dimension is a dimension scale with netCDF-C's NAME and no data.",
        "- The v4_* files are written at libver \"latest\" (version-4 layouts: the chunk indexes that",
        "  check_structure names). netCDF-C sets a low bound of v1.8, so its files have version-3 layouts;",
        "  nc_committed_types.nc is written at that bound.",
        "- nc_committed_types.nc commits its enum, compound and vlen types in the root group as netCDF-C",
        "  does; its expected frame reads the variables the JAX reader can (\"variables\" in the entry):",
        "  that reader takes a committed datatype for a variable, and its CF decode refuses compounds.",
        "- nc_shared_messages.nc (every message type shared through one index of the shared-message table),",
        "  nc_filtered_heap.nc (the root group's links in a deflated fractal heap), nc_four_byte.nc (4-byte",
        "  offsets and lengths), nc_external.nc (variables in nc_external.raw, named relative to the working",
        "  directory: its expected frame is read from this directory) and nc_virtual.nc (virtual variables over",
        "  nc_virtual_src.h5, the file itself and a missing file) are netCDF-shaped files of settings netCDF-C",
        "  does not use; region_refs.h5 holds region references, its expected frame every element they select",
        "  (chip_smoke.region_frame, through h5py).",
        "- vds_obs.nc maps chip_smoke.py phase 7's observation rows from granule files that are not here:",
        "  phase 17 (i) writes them with the port's own writer.",
    ]
    (out / "MANIFEST.txt").write_text("\n".join(manifest) + "\n")
    print(f"wrote {len(files)} files to {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures" / "hdf5"))
    out = Path(ap.parse_args(argv).out)
    make(out)
    write_restart_stores(out)
    for name in RESTART_STORES:
        check_structure(out / name)
    write_manifest(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
