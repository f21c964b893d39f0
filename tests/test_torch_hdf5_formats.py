"""The port's HDF5 codec (gpsat_tpu_torch/data/hdf5.py) on the later formats
that PyTables and netCDF-4 files use: every variant written here by h5py
and read through the port, held to h5py and to the JAX package's h5py
readers (``gpsat_tpu.data.pytables_compat.read_table``,
``gpsat_tpu.data.netcdf.read_netcdf``) exactly; the port's netCDF writer
against the JAX writer; the fixtures of tests/fixtures/hdf5 against their
expected frames; and the files the codec refuses, each with a named
FormatError. No JAX program is compiled."""

import importlib.util
import pickle
import struct
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gpsat_tpu.data import dataloader as JDL
from gpsat_tpu.data import ingest as JI
from gpsat_tpu.data import netcdf as JN
from gpsat_tpu.data import pytables_compat as JPT
from gpsat_tpu.data.store import TableStore as JStore
from gpsat_tpu_torch.data import dataloader as TDL
from gpsat_tpu_torch.data import hdf5
from gpsat_tpu_torch.data import hdf5_structures
from gpsat_tpu_torch.data import ingest as TI
from gpsat_tpu_torch.data import netcdf as TN
from gpsat_tpu_torch.data import pytables_compat as TPT
from gpsat_tpu_torch.data.blosc import blosc_encode
from gpsat_tpu_torch.data.store import TableStore as TStore

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

_spec = importlib.util.spec_from_file_location("make_hdf5_fixtures", REPO / "tools" / "make_hdf5_fixtures.py")
FX = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(FX)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other port tests pin it under tier-1's
    six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# every object of a file, as h5py and the port read it
# --------------------------------------------------------------------------


def _same(want, got, what):
    if isinstance(want, h5py.Empty):
        assert isinstance(got, hdf5.Empty) and got.dtype == want.dtype, what
    elif isinstance(want, np.ndarray) and want.dtype == object and want.size and isinstance(
            want.reshape(-1)[0], h5py.Reference):
        assert got.dtype == np.uint64 and got.shape == want.shape, what  # object references: header addresses
    elif isinstance(want, np.ndarray) and want.dtype == object:
        assert isinstance(got, np.ndarray) and got.dtype == object and got.shape == want.shape, what
        for w, g in zip(want.reshape(-1), got.reshape(-1)):
            if isinstance(w, np.ndarray):
                assert w.dtype == g.dtype, what
                np.testing.assert_array_equal(g, w, err_msg=what)
            elif isinstance(w, h5py.Reference):
                continue  # held through the dims below
            else:  # h5py gives a dataset's variable-length strings as bytes, the codec as str
                assert (w.decode() if isinstance(w, bytes) else w) == g, what
    elif isinstance(want, (bytes, str)) or np.isscalar(want):
        assert type(got) is type(want) and (got == want or (got != got and want != want)), (what, want, got)
    else:
        want, got = np.asarray(want), np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, (what, want.dtype, got.dtype)
        if want.dtype.names:
            assert got.tobytes() == want.tobytes(), what
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)


def _walk(h, c, path="/"):
    assert c.attrs.keys() == list(h.attrs.keys()), path
    for k in h.attrs.keys():
        if k not in ("REFERENCE_LIST", "DIMENSION_LIST"):
            _same(h.attrs[k], c.attrs[k], f"{path} attr {k}")
    if isinstance(h, h5py.Group):
        assert c.keys() == list(h.keys()), path
        for k in h.keys():
            link = h.get(k, getlink=True)
            if isinstance(link, h5py.HardLink):
                _walk(h[k], c[k], f"{path}{k}/")
            else:
                with pytest.raises(hdf5.FormatError, match="soft link|external link"):
                    c[k]
        return
    assert c.shape == h.shape, path
    _same(h[()], c[()], path)
    for axis in range(h.ndim):
        assert [s.name for _, s in c.dims[axis].items()] == [s.name for s in h.dims[axis].values()], path


def _same_as_h5py(path):
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as c:
        _walk(h, c.root)
        return c.superblock_version


# --------------------------------------------------------------------------
# superblocks, object headers, groups and attributes
# --------------------------------------------------------------------------


def _write_structures(path, libver, track):
    """20 links and 20 attributes (dense past 8) and one attribute beyond a
    fractal heap's managed size, beside soft and external links."""
    with h5py.File(path, "w", libver=FX.LIBVER[libver], track_order=track) as f:
        g = f.create_group("many", track_order=track)
        for i in range(20):
            g.attrs[f"a{(7 * i) % 20:02d}"] = np.int64(i)
            g.create_dataset(f"d{(7 * i) % 20:02d}", data=np.arange(i + 1, dtype="i4"))
        g.attrs["big"] = np.arange(3000, dtype="f8")
        f.create_dataset("x", data=np.arange(5.0))
        f["soft"] = h5py.SoftLink("/x")
        f.create_group("links")["ext"] = h5py.ExternalLink("other.h5", "/x")  # link messages, even at earliest
        f["links/soft"] = h5py.SoftLink("/many")
        f.attrs["note"] = "é"


@pytest.mark.parametrize("track", [False, True], ids=["untracked", "tracked"])
@pytest.mark.parametrize("libver", ["earliest", "earliest_v108", "v108"])
def test_superblocks_headers_and_groups_read_as_h5py(libver, track, tmp_path):
    path = str(tmp_path / "f.h5")
    _write_structures(path, libver, track)
    assert _same_as_h5py(path) == (2 if libver == "v108" else 0)
    with hdf5.File(path, "r") as f:
        g = f["many"]
        # a new-style group (link messages, dense past 8) where the low bound or creation order asks for one
        assert (g._link_info is not None) == (libver == "v108" or track)
    # a later format is read, never written; a symbol-table group beside it is
    if libver == "v108":
        with pytest.raises(hdf5.FormatError, match="superblock version 2"):
            hdf5.File(path, "r+")
        return
    with hdf5.File(path, "r+") as f:
        if track:
            with pytest.raises(hdf5.FormatError, match="new-style group|version-2 object header|dense storage"):
                f["many"].attrs["x"] = "y"
        else:
            f["many"].attrs["x"] = "y"
            f.create_dataset("y", np.arange(3.0), contiguous=True)
    _same_as_h5py(path)


def test_dense_links_and_attributes_beyond_one_block(tmp_path):
    # 1,500 links and 700 attributes of 800 bytes: indirect fractal-heap
    # blocks nested two deep and version-2 B-trees of depth 2
    path = str(tmp_path / "deep.h5")
    with h5py.File(path, "w", libver=("v108", "v108"), track_order=True) as f:
        g = f.create_group("g")
        for i in range(1500):
            g.create_group(f"link_with_a_longer_name_{(i * 7919) % 1500:05d}")
        for i in range(700):
            g.attrs[f"attr_{i:04d}"] = np.full(100, i, dtype="f8")
    walks, depths = [], []
    real_walk, real_records = hdf5_structures.FractalHeap._walk_indirect, hdf5_structures.btree2_records

    def walk(self, addr, rows, off):
        walks.append(rows)
        return real_walk(self, addr, rows, off)

    def records(read, addr, path):
        depths.append(struct.unpack_from("<H", read(addr, 14), 12)[0])
        return real_records(read, addr, path)

    hdf5_structures.FractalHeap._walk_indirect = walk
    hdf5.btree2_records = records
    try:
        with hdf5.File(path, "r") as f, h5py.File(path, "r") as h:
            assert f["g"].keys() == list(h["g"].keys())
            assert f["g"].attrs.keys() == list(h["g"].attrs.keys())
            for k in list(h["g"].attrs.keys())[::37]:
                np.testing.assert_array_equal(f["g"].attrs[k], h["g"].attrs[k])
    finally:
        hdf5_structures.FractalHeap._walk_indirect = real_walk
        hdf5.btree2_records = real_records
    assert len(walks) >= 3 and max(depths) >= 2, (walks, depths)


def _tiny_id(id_len, payload):
    """A tiny object's heap ID as HDF5's H5HF__tiny_insert lays it out: the
    length less one in the first byte's low four bits while the ID leaves
    at most 16 bytes after that byte (or 18 bytes in all, where a second
    length byte would leave room for no more), else in twelve bits over two
    bytes."""
    n = len(payload) - 1
    if id_len <= 18:
        head = bytes([0x20 | n])
    else:
        head = bytes([0x20 | (n >> 8), n & 0xFF])
    return (head + payload).ljust(id_len, b"\0")


@pytest.mark.parametrize("id_len", [17, 18, 19, 24])
def test_tiny_heap_objects_at_the_id_length_boundary(id_len):
    # a fractal heap header of ``id_len``-byte IDs and no blocks, built by
    # hand: h5py's heaps use IDs of 7 (links) or 8 (attributes) bytes
    head = bytearray(142)
    head[:5] = b"FRHP\0"
    struct.pack_into("<HHBI", head, 5, id_len, 0, 0, 4096)
    struct.pack_into("<Q", head, 22, hdf5_structures.UNDEF)
    struct.pack_into("<HQQHHQH", head, 110, 4, 512, 65536, 32, 1, hdf5_structures.UNDEF, 0)
    buf = bytes(head) + struct.pack("<I", hdf5_structures.lookup3(bytes(head)))
    heap = hdf5_structures.FractalHeap(lambda addr, n: buf[addr:addr + n], 0, "hand-built")
    longest = id_len - 1 if id_len <= 17 else 16 if id_len == 18 else id_len - 2
    for n in sorted({1, 15, 16, longest}):
        payload = bytes(range(100, 100 + n))
        assert heap.get(_tiny_id(id_len, payload)) == payload, n


# --------------------------------------------------------------------------
# layouts and filters
# --------------------------------------------------------------------------


def _direct_chunks(f, name, data, chunk, filter_id, encode, client=(), raw_chunks=()):
    """A chunked dataset through ``filter_id`` (an optional filter h5py
    cannot apply), its chunks written whole by write_direct_chunk; the
    chunks at the offsets in ``raw_chunks`` (every chunk for True) stored
    unfiltered, their mask bit set."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunk)
    dcpl.set_filter(filter_id, h5py.h5z.FLAG_OPTIONAL, client)
    space = h5py.h5s.create_simple(data.shape)
    ds = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype), space, dcpl=dcpl)
    for lo in np.ndindex(*[-(-n // c) for n, c in zip(data.shape, chunk)]):
        off = tuple(i * c for i, c in zip(lo, chunk))
        block = np.zeros(chunk, data.dtype)
        part = data[tuple(slice(o, o + c) for o, c in zip(off, chunk))]
        block[tuple(slice(0, n) for n in part.shape)] = part
        if raw_chunks is True or off in raw_chunks:
            ds.write_direct_chunk(off, block.tobytes(), filter_mask=1)
        else:
            ds.write_direct_chunk(off, encode(block.tobytes()), filter_mask=0)


LAYOUTS = ["contiguous", "compact", "chunked_edges", "gzip_shuffle_fletcher32", "blosc", "bzip2", "missing_chunk",
           "big_endian_chunked", "optional_unknown_filter_skipped"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layouts_and_filters(layout, tmp_path):
    import bz2

    path = str(tmp_path / "l.h5")
    rng = np.random.default_rng(3)
    data = rng.normal(size=(13, 7, 5))
    with h5py.File(path, "w") as f:
        if layout == "contiguous":
            f.create_dataset("v", data=data)
        elif layout == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            data = data[:2, :3]
            ds = h5py.h5d.create(f.id, b"v", h5py.h5t.IEEE_F64LE, h5py.h5s.create_simple(data.shape), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))
        elif layout == "chunked_edges":
            f.create_dataset("v", data=data, chunks=(4, 3, 2), maxshape=(None, 7, 5))
        elif layout == "gzip_shuffle_fletcher32":
            f.create_dataset("v", data=data, chunks=(4, 3, 2), compression="gzip", shuffle=True, fletcher32=True)
        elif layout == "blosc":
            _direct_chunks(f, "v", data, (4, 3, 2), 32001, lambda b: blosc_encode(b, 8, cname="lz4", shuffle=1),
                           (2, 2, 8, 192, 5, 1, 1), raw_chunks={(4, 3, 2)})
        elif layout == "bzip2":
            _direct_chunks(f, "v", data, (4, 3, 2), 307, lambda b: bz2.compress(b, 9), (9,))
        elif layout == "optional_unknown_filter_skipped":  # a filter no chunk went through
            _direct_chunks(f, "v", data, (4, 3, 2), 32099, None, raw_chunks=True)
        elif layout == "missing_chunk":
            f.create_dataset("v", shape=data.shape, chunks=(4, 3, 2), dtype="f8", fillvalue=-7.5)
            f["v"][0:4, 0:3] = data[0:4, 0:3]
            f["v"][12:, 6:] = data[12:, 6:]
            data = f["v"][()]
        else:
            data = data.astype(">f4")
            f.create_dataset("v", data=data, chunks=(5, 5, 5), compression="gzip")
    with hdf5.File(path, "r") as f:
        got = f["v"][()]
    assert got.dtype == data.dtype
    np.testing.assert_array_equal(got, data)
    if layout in ("contiguous", "compact", "chunked_edges", "gzip_shuffle_fletcher32", "missing_chunk",
                  "big_endian_chunked"):  # h5py lacks the other filters
        assert _same_as_h5py(path) == 0


def test_layout_messages_of_versions_1_and_2(tmp_path):
    # HDF5 1.6's layout messages, written here over h5py's version-3 ones in
    # place (the same 24 bytes): contiguous at version 1, chunked at version
    # 2, the dims with the element size last; h5py reads them too
    path = str(tmp_path / "old.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("c", data=np.arange(10.0))
        f.create_dataset("k", data=np.arange(10, dtype="<i4"), chunks=(4,), maxshape=(None,))
    with hdf5.File(path, "r") as f:
        c_body = [b for t, _, b, _ in hdf5._read_header(f, f["c"]._addr)[2] if t == hdf5.LAYOUT][0]
        k_body = [b for t, _, b, _ in hdf5._read_header(f, f["k"]._addr)[2] if t == hdf5.LAYOUT][0]
    c_addr = struct.unpack_from("<Q", c_body, 2)[0]
    k_addr = struct.unpack_from("<Q", k_body, 3)[0]
    old = {c_body: struct.pack("<BBB5xQII", 1, 2, 1, c_addr, 10, 8),
           k_body: struct.pack("<BBB5xQII", 2, 2, 2, k_addr, 4, 4)}
    raw = Path(path).read_bytes()
    for new_body, old_body in old.items():
        assert len(new_body) == len(old_body) == 24 and raw.count(new_body) == 1
        raw = raw.replace(new_body, old_body)
    Path(path).write_bytes(raw)
    assert _same_as_h5py(path) == 0
    with hdf5.File(path, "r") as f:
        np.testing.assert_array_equal(f["c"][()], np.arange(10.0))
        np.testing.assert_array_equal(f["k"][()], np.arange(10, dtype="<i4"))


# --------------------------------------------------------------------------
# datatypes
# --------------------------------------------------------------------------


def test_datatypes_read_as_h5py(tmp_path):
    path = str(tmp_path / "t.h5")
    rng = np.random.default_rng(5)
    with h5py.File(path, "w") as f:
        for pad, name in ((h5py.h5t.STR_NULLTERM, "nullterm"), (h5py.h5t.STR_NULLPAD, "nullpad"),
                          (h5py.h5t.STR_SPACEPAD, "spacepad")):
            t = h5py.h5t.C_S1.copy()
            t.set_size(5)
            t.set_strpad(pad)
            ds = h5py.h5d.create(f.id, name.encode(), t, h5py.h5s.create_simple((4,)))
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array([b"ab", b"abcde", b"", b"a  c"], dtype="S5"))
        for order in "<>":
            f.create_dataset(f"i{order}", data=rng.integers(-9, 9, 6).astype(f"{order}i8"))
            f.create_dataset(f"u{order}", data=rng.integers(0, 9, 6).astype(f"{order}u2"))
            f.create_dataset(f"f{order}", data=rng.normal(size=6).astype(f"{order}f8"))
        f.create_dataset("f2", data=rng.normal(size=4).astype("f2"))
        bits = h5py.h5d.create(f.id, b"bits", h5py.h5t.STD_B16BE, h5py.h5s.create_simple((3,)))
        bits.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array([1, 2, 65535], ">u2"), mtype=h5py.h5t.STD_B16BE)
        f.create_dataset("bool", data=np.array([True, False, True]))
        f.create_dataset("enum", data=np.array([0, 5, 5], "i2"), dtype=h5py.enum_dtype({"A": 0, "B": 5}, "i2"))
        inner = np.dtype([("a", "<i2"), ("b", ">f4", (2,))])
        ct = np.dtype({"names": ["index", "block", "flag", "name", "e", "inner"],
                       "formats": ["<i8", ("<f8", (3,)), "?", "S6", h5py.enum_dtype({"X": 0, "Y": 3}, "i1"), inner],
                       "offsets": [0, 16, 40, 44, 51, 56], "itemsize": 72})  # gaps between members
        rec = np.zeros(9, ct)
        rec["index"], rec["block"] = np.arange(9), rng.normal(size=(9, 3))
        rec["flag"], rec["name"], rec["e"] = np.arange(9) % 2 == 0, [b"n%d" % i for i in range(9)], np.arange(9) % 2 * 3
        rec["inner"]["a"], rec["inner"]["b"] = np.arange(9), rng.normal(size=(9, 2))
        f.create_dataset("compound", data=rec, chunks=(4,), compression="gzip")
        arr = h5py.h5d.create(f.id, b"array", h5py.h5t.array_create(h5py.h5t.IEEE_F32BE, (2, 3)),
                              h5py.h5s.create_simple((4,)))
        arr.write(h5py.h5s.ALL, h5py.h5s.ALL, rng.normal(size=(4, 2, 3)).astype(">f4"),
                  mtype=h5py.h5t.array_create(h5py.h5t.IEEE_F32BE, (2, 3)))
        f.create_dataset("vlen", (3,), dtype=h5py.vlen_dtype(np.int16))[...] = [
            np.arange(2, dtype="i2"), np.arange(0, dtype="i2"), np.arange(5, dtype="i2")]
        f.create_dataset("vstr", data=np.array(["x", "", "yé"], dtype=object), dtype=h5py.string_dtype())
        f.create_dataset("scalar", data=np.float32(2.5))
        refs = f.create_dataset("refs", (2,), dtype=h5py.ref_dtype)
        refs[0], refs[1] = f["bool"].ref, f["compound"].ref
        f.attrs["opaque"] = np.void(pickle.dumps(["a", 1]))
        f.attrs["empty"] = h5py.Empty("f8")
        f.attrs["fixed"] = np.bytes_(b"TABLE")
        f.attrs["fixed_array"] = np.array([b"a", b"bc"])
        f.attrs["vlen_array"] = np.array(["a", "bé"], dtype=object)
        f.attrs["ints"] = np.arange(3)
        f.attrs["compound"] = rec[0]
    assert _same_as_h5py(path) == 0
    with hdf5.File(path, "r") as f:
        assert [f.deref(int(a)).name for a in f["refs"][()]] == ["/bool", "/compound"]
        assert pickle.loads(f.attrs["opaque"]) == ["a", 1]


@settings(max_examples=20, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(dtype=st.sampled_from(["<i1", ">i2", "<u4", ">u8", "<f4", ">f8", "?", "S3"]),
       shape=st.lists(st.integers(0, 6), min_size=0, max_size=3).map(tuple),
       layout=st.sampled_from(["contiguous", "chunked", "gzip"]), seed=st.integers(0, 2**16))
def test_round_trip_property(dtype, shape, layout, seed, tmp_path):
    # any of these dtypes, shapes and layouts written by h5py reads back
    # through the codec as h5py reads it
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 100, shape).astype(dtype) if np.dtype(dtype).kind != "f" else rng.normal(size=shape)
    data = np.asarray(data, dtype=dtype)
    path = str(tmp_path / f"p{seed}.h5")
    kw = {}
    if layout != "contiguous" and len(shape) and all(shape):
        kw = {"chunks": tuple(max(1, n // 2) for n in shape), **({"compression": "gzip"} if layout == "gzip" else {})}
    with h5py.File(path, "w") as f:
        f.create_dataset("v", data=data, **kw)
    assert _same_as_h5py(path) == 0


# --------------------------------------------------------------------------
# the readers: PyTables tables and netCDF-4 files, against the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("storage", FX.PYTABLES_VARIANTS)
def test_pytables_tables_match_jax(storage, tmp_path):
    path, plain = str(tmp_path / "p.h5"), str(tmp_path / "plain.h5")
    FX.write_pytables(path, storage, n=200)
    FX.write_pytables(plain, "plain", n=200)  # the JAX reader's file where h5py lacks the filter
    ref = path if storage in ("plain", "zlib") else plain
    assert TPT.list_tables(path) == JPT.list_tables(ref) == ["data", "lengthscales"]
    for key in ("data", "lengthscales"):
        want = JPT.read_table(ref, key)
        pd.testing.assert_frame_equal(TPT.read_table(path, key), want)
        with TPT.open_store(path) as s:
            pd.testing.assert_frame_equal(s.select(key), want)
    where = [{"col": "sat", "comp": "==", "val": "S3A"}]
    pd.testing.assert_frame_equal(TPT.read_table(path, "data", where=where), JPT.read_table(ref, "data", where=where))
    pd.testing.assert_frame_equal(TDL.load(path, table="data"), JDL.load(ref, table="data"))


@pytest.mark.parametrize("variant", sorted(FX.NETCDF_VARIANTS))
def test_netcdf_files_match_jax(variant, tmp_path):
    path = str(tmp_path / f"{variant}.nc")
    FX.write_netcdf_variant(path, **FX.NETCDF_VARIANTS[variant])
    pd.testing.assert_frame_equal(TN.read_netcdf(path), JN.read_netcdf(path))
    pd.testing.assert_frame_equal(TN.read_netcdf(path, variables=["count"]),
                                  JN.read_netcdf(path, variables=["count"]))
    pd.testing.assert_frame_equal(TN.read_netcdf(path, decode_cf=False), JN.read_netcdf(path, decode_cf=False))
    pd.testing.assert_frame_equal(TDL.load(path), JDL.load(path))


def test_read_and_store_nc_engine_matches_jax(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(3):
        FX.write_netcdf_variant(str(raw / f"f{i}.nc"), libver="v108", track_order=True, layout="filtered", seed=i)
    for pkg, fn in (("jax", JI.read_and_store), ("port", TI.read_and_store)):
        fn({"file": str(tmp_path / f"{pkg}.h5"), "table": "data"}, str(raw), r"f\d\.nc", read_engine="nc")
    with JStore(str(tmp_path / "jax.h5"), mode="r") as j, TStore(str(tmp_path / "port.h5"), mode="r") as t:
        pd.testing.assert_frame_equal(t.select("data"), j.select("data"))


def test_netcdf_reader_refuses_groups(tmp_path):
    path = str(tmp_path / "g.nc")
    with h5py.File(path, "w", libver=("v108", "v108")) as f:
        f.create_group("sub")
    for read in (TN.read_netcdf, JN.read_netcdf):
        with pytest.raises(NotImplementedError, match="group 'sub'"):
            read(path)


def _frames():
    rng = np.random.default_rng(1)
    idx = pd.MultiIndex.from_product([np.arange(3.0), np.array([10, 20]), pd.to_datetime(["2020-01-01",
                                                                                          "2020-01-02"])],
                                     names=["x", "k", "t"])
    df = pd.DataFrame({"a": rng.normal(size=12), "b": np.arange(12), "s": np.array(list("abcdefghijkl"), dtype=object),
                       "ok": rng.random(12) > 0.5, "when": pd.date_range("2020", periods=12)}, index=idx)
    return {"multiindex": (df.iloc[:-1], {}), "flat": (df.reset_index(), {}),
            "dict": ({"z": (("x", "y"), rng.normal(size=(3, 4))), "w": ("y", np.arange(4, dtype=np.int32))},
                     {"coords": {"x": np.arange(3.0), "y": np.array(["p", "q", "r", "s"], dtype=object)}})}


@pytest.mark.parametrize("case", ["multiindex", "flat", "dict"])
def test_write_netcdf_matches_jax_writer(case, tmp_path):
    obj, kw = _frames()[case]
    port, jax = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    TN.write_netcdf(port, obj, **kw)
    JN.write_netcdf(jax, obj, **kw)

    def dims(path):
        with h5py.File(path, "r") as f:
            return {k: [[s.name for s in f[k].dims[i].values()] for i in range(f[k].ndim)] for k in f}, {
                k: f[k][()] for k in f}

    (port_dims, port_vals), (jax_dims, jax_vals) = dims(port), dims(jax)
    assert port_dims == jax_dims
    for k in jax_vals:
        np.testing.assert_array_equal(port_vals[k], jax_vals[k])
    want = JN.read_netcdf(jax)
    for read in (TN.read_netcdf, JN.read_netcdf):
        pd.testing.assert_frame_equal(read(port), want)
    _same_as_h5py(port)


@pytest.mark.parametrize("changed", ["scale", "variable", "both"])
def test_flushing_again_keeps_dimension_lists_in_place(changed, tmp_path):
    # a second flush that moves a scale, its variable or both to new headers
    # writes no new DIMENSION_LIST objects, and h5py finds the moved headers
    path = str(tmp_path / "dims.nc")
    f = hdf5.File(path, "w")
    x = f.create_dataset("x", np.arange(3.0), contiguous=True)
    x.make_scale("x")
    y = f.create_dataset("y", np.arange(2.0), contiguous=True)
    y.make_scale("y")
    v = f.create_dataset("v", np.zeros((3, 2)), contiguous=True)
    v.dims[0].attach_scale(x)
    v.dims[1].attach_scale(y)
    f.flush()
    objects = f._gheap[3]
    if changed in ("scale", "both"):
        x.attrs["scale_factor"] = np.int64(2)
    if changed in ("variable", "both"):
        v.attrs["scale_factor"] = np.int64(3)
    f.flush()
    assert f._gheap[3] == objects
    f.close()
    with h5py.File(path, "r") as h:
        for axis, scale in enumerate(("x", "y")):
            assert h5py.h5ds.is_attached(h["v"].id, h[scale].id, axis)
            assert [s.name for s in h["v"].dims[axis].values()] == [f"/{scale}"]
        assert h["v"].dims[0][0].attrs.get("scale_factor") == (2 if changed != "variable" else None)
        for scale in ("x", "y"):
            assert h[h[scale].attrs["REFERENCE_LIST"][0]["dataset"]].attrs.get("scale_factor") == (
                3 if changed != "scale" else None)
    _same_as_h5py(path)


# --------------------------------------------------------------------------
# the fixtures the card is held to
# --------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(CS.formats_expected())))
def test_fixture_frames_match_expected(i):
    entry, arrays = CS.formats_expected()[i]
    assert CS.frame_differences(CS.read_fixture(entry), entry, arrays) == []


def test_fixtures_are_what_the_tool_writes(tmp_path):
    # the committed fixtures' expected frames are the JAX readers' of files
    # the tool writes now
    FX.make(tmp_path)
    fresh = CS.formats_expected(tmp_path)
    committed = CS.formats_expected()
    assert [e for e, _ in fresh] == [e for e, _ in committed]
    for (entry, arrays), (_, want) in zip(fresh, committed):
        assert sorted(arrays) == sorted(want), entry["file"]
        for k in want:
            np.testing.assert_array_equal(arrays[k], want[k], err_msg=f"{entry['file']} {k}")


# --------------------------------------------------------------------------
# what the codec refuses
# --------------------------------------------------------------------------


def _flip_chunk_byte(path, name):
    with hdf5.File(path, "r") as f:
        offsets, addrs, sizes, _ = f[name]._chunk_index()
        addr = int(addrs[0]) + int(sizes[0]) // 2
    with open(path, "r+b") as fh:
        fh.seek(addr)
        b = fh.read(1)
        fh.seek(addr)
        fh.write(bytes([b[0] ^ 0xFF]))


REFUSALS = {
    "fletcher32_mismatch": "fletcher32 checksum mismatch",
    "layout_v4_extensible_array": "version-4 layout with a extensible array chunk index",
    "layout_v4_fixed_array": "version-4 layout with a fixed array chunk index",
    "unknown_filter_lzf": r"filter 32000 \(lzf\)",
    "region_reference": "region reference",
    "committed_datatype": "committed",
    "four_byte_offsets": "4-byte offsets",
    "user_block": "user block",
    "superblock_checksum": "checksum of the superblock",
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_codec_names_what_it_refuses(kind, tmp_path):
    path = str(tmp_path / "r.h5")
    data = np.arange(40.0)
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    if kind == "four_byte_offsets":
        fcpl.set_sizes(4, 4)
    if kind == "user_block":
        fcpl.set_userblock(512)
    libver = "latest" if kind.startswith("layout_v4") or kind == "superblock_checksum" else "earliest"
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(*{"latest": (h5py.h5f.LIBVER_LATEST,) * 2,
                             "earliest": (h5py.h5f.LIBVER_EARLIEST, h5py.h5f.LIBVER_LATEST)}[libver])
    with h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl)) as f:
        if kind == "fletcher32_mismatch":
            f.create_dataset("v", data=data, chunks=(8,), fletcher32=True)
        elif kind == "layout_v4_extensible_array":
            f.create_dataset("v", data=data, chunks=(8,), maxshape=(None,))
        elif kind == "layout_v4_fixed_array":
            f.create_dataset("v", data=data, chunks=(8,))
        elif kind == "unknown_filter_lzf":
            f.create_dataset("v", data=data, chunks=(8,), compression="lzf")
        elif kind == "region_reference":
            f.create_dataset("x", data=data)
            r = f.create_dataset("v", (1,), dtype=h5py.regionref_dtype)
            r[0] = f["x"].regionref[1:3]
        elif kind == "committed_datatype":
            f["t"] = np.dtype("f8")
            f.create_dataset("v", data=data, dtype=f["t"])
        else:
            f.create_dataset("v", data=data)
    if kind == "fletcher32_mismatch":
        _flip_chunk_byte(path, "v")
    if kind == "superblock_checksum":
        with open(path, "r+b") as fh:
            fh.seek(28)  # the end-of-file address
            fh.write(struct.pack("<Q", 1 << 40))
    with pytest.raises(hdf5.FormatError, match=REFUSALS[kind]):
        with hdf5.File(path, "r") as f:
            f["v"][()]
