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
- ``expected.npz``: each fixture's frame as the JAX package's readers
  (``gpsat_tpu.data.pytables_compat.read_table``,
  ``gpsat_tpu.data.netcdf.read_netcdf``) give it, through h5py; its
  ``meta`` entry (JSON) says which file, reader and table each frame is;
- ``MANIFEST.txt``: the files and what h5py could not lay out the way
  PyTables or netCDF-C would.

The writers are also what ``tests/test_torch_hdf5_formats.py`` calls to
write its variants.
"""

from __future__ import annotations

import argparse
import bz2
import json
import pickle
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# PyTables' filter ids and the blosc filter's compressor code for lz4
BLOSC_ID, BZIP2_ID, BLOSC_LZ4 = 32001, 307, 1
PHONY_NAME = b"This is a netCDF dimension but not a netCDF variable."
LIBVER = {"earliest": "earliest", "earliest_v108": ("earliest", "v108"), "v108": ("v108", "v108")}


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


def results_store(path, experts, seed=0):
    """A GPSat results store (PyTables) of ``experts`` ({"x", "y"}): the
    lengthscales (one row per dimension, ``_dim_0``), kernel_variance and
    likelihood_variance of each, in the units the runs store (lengthscales
    over coords_scale), f32-representable so that an f32 run loads them
    exactly."""
    import h5py

    rng = np.random.default_rng(seed)
    e = len(experts["x"])
    x, y = np.asarray(experts["x"], float), np.asarray(experts["y"], float)
    ls = rng.uniform(1.0, 8.0, (e, 2)).astype(np.float32).astype(np.float64)
    kv = rng.uniform(0.01, 0.1, e).astype(np.float32).astype(np.float64)
    lv = rng.uniform(1e-3, 1e-2, e).astype(np.float32).astype(np.float64)
    with h5py.File(path, "w") as f:
        _bytes_attr(f, "CLASS", "GROUP")
        write_frame_table(f, "lengthscales", index_fields={"x": (np.repeat(x, 2), "float"),
                                                           "y": (np.repeat(y, 2), "float")},
                          blocks=[("values_block_0", ["_dim_0", "lengthscales"],
                                   np.stack([np.tile([0.0, 1.0], e), ls.reshape(-1)], axis=1))],
                          storage="zlib", chunk_rows=32)
        for name, vals in (("kernel_variance", kv), ("likelihood_variance", lv)):
            write_frame_table(f, name, index_fields={"x": (x, "float"), "y": (y, "float")},
                              blocks=[("values_block_0", [name], vals[:, None])], storage="zlib", chunk_rows=32)
    return {"lengthscales": ls, "kernel_variance": kv, "likelihood_variance": lv}


# --------------------------------------------------------------------------
# netCDF-4 layout
# --------------------------------------------------------------------------


def write_netcdf_variant(path, libver="earliest", track_order=False, layout="contiguous", extra=0, phony=False,
                         cf_time=True, seed=0):
    """A netCDF-4-layout file as h5py can lay it out: dimension scales x
    (7), y (11) and t (5) with coordinate variables, a [7, 11, 5] float
    variable and a [11, 5] int variable, a string variable over x; the
    library-version bounds and creation order as given (netCDF-C: v1.8,
    tracked); ``layout`` "contiguous", "chunked" (edge chunks: chunks of
    (3, 4, 2)) or "filtered" (those chunks through shuffle, deflate and
    fletcher32); ``extra`` more variables over x, each with as many
    attributes (dense links and attributes past 8); ``phony`` a dimension
    with no coordinate variable, as netCDF-C writes it; ``cf_time`` t in
    "days since" with a _FillValue, else plain integers."""
    import h5py

    rng = np.random.default_rng(seed)
    kw = {}
    if layout in ("chunked", "filtered"):
        kw = {"chunks": (3, 4, 2)}
        if layout == "filtered":
            kw.update(compression="gzip", shuffle=True, fletcher32=True)
    with h5py.File(path, "w", libver=LIBVER[libver], track_order=track_order) as f:
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
            for j in range(extra):
                v.attrs[f"a{j:02d}"] = np.int64(i * j)


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
# the fixtures and their expected frames
# --------------------------------------------------------------------------


def frame_arrays(df):
    """A frame as (meta, arrays): each column and index level an array
    (strings as unicode), with the dtypes and names to check it by."""
    cols, arrays = [], {}
    for j, c in enumerate(df.columns):
        vals = df[c].to_numpy()
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
    import h5py

    import chip_smoke as cs
    from gpsat_tpu.data import netcdf as JN
    from gpsat_tpu.data import pytables_compat as JPT

    out.mkdir(parents=True, exist_ok=True)
    entries, arrays = [], {}

    def expect(file, reader, key, df):
        meta, arrs = frame_arrays(df)
        i = len(entries)
        entries.append({"file": file, "reader": reader, "key": key, **meta})
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
    np.savez_compressed(out / "expected.npz", meta=np.array(json.dumps(entries)), **arrays)
    files = sorted(p.name for p in out.iterdir() if p.suffix in (".h5", ".nc"))
    manifest = [
        "HDF5 fixtures of the port's codec (tools/make_hdf5_fixtures.py; written by h5py "
        f"{h5py.__version__}, HDF5 {h5py.version.hdf5_version}).",
        "expected.npz holds each file's frame as the JAX package's h5py readers give it.",
        "",
        "Files:",
        *[f"  {p} ({(out / p).stat().st_size} bytes)" for p in files],
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
        "- Library-version bounds stop at v1.8, as netCDF-C sets them; no file has a version-4 layout.",
    ]
    (out / "MANIFEST.txt").write_text("\n".join(manifest) + "\n")
    print(f"wrote {len(files)} files and {len(entries)} expected frames to {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures" / "hdf5"))
    make(Path(ap.parse_args(argv).out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
