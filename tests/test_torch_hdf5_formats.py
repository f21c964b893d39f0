"""The port's HDF5 codec (gpsat_tpu_torch/data/hdf5.py) on the later formats
that PyTables and netCDF-4 files use and on what h5py writes under its
usual options (libver "latest": every version-4 chunk index, by filter and
rank; the lzf filter, its C++ and Python decoders; committed datatypes;
user blocks; and the files it once refused, read since: the shared-message
table, filtered fractal heaps, 4-byte offsets, external and virtual
storage, region references, whose own cases are in
tests/test_torch_hdf5_shared.py): every variant written here by h5py and
read through the port, held to h5py and to the JAX package's h5py readers
(``gpsat_tpu.data.pytables_compat.read_table``,
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
from gpsat_tpu_torch.data.lzf import lzf_decode
from gpsat_tpu_torch.data.store import TableStore as TStore

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

FX_DIR = REPO / "tests" / "fixtures" / "hdf5"
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


def _same(want, got, what, files=None):
    """``got`` (the codec's) is ``want`` (h5py's); region references are
    held through ``files`` (h5py's File, the codec's): each names the same
    object, and selects the same values there in the same shape."""
    if isinstance(want, h5py.Empty):
        assert isinstance(got, hdf5.Empty) and got.dtype == want.dtype, what
    elif isinstance(want, h5py.RegionReference):  # a scalar's
        _same(np.array([want], object), np.array([got], object), what, files)
    elif isinstance(want, np.ndarray) and want.dtype == object and want.size and isinstance(
            want.reshape(-1)[0], h5py.RegionReference):
        assert got.dtype == object and got.shape == want.shape, what
        h, c = files
        for w, g in zip(want.reshape(-1), got.reshape(-1)):
            if not w:
                assert g is None, what
                continue
            assert isinstance(g, hdf5.RegionReference) and c[g].name == h[w].name, (what, h[w].name)
            _same(h[w][w], c[g][g], f"{what} -> {h[w].name}")
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
    files = (h.file, c._file)
    assert c.attrs.keys() == list(h.attrs.keys()), path
    for k in h.attrs.keys():
        if k not in ("REFERENCE_LIST", "DIMENSION_LIST"):
            _same(h.attrs[k], c.attrs[k], f"{path} attr {k}", files)
    if isinstance(h, h5py.Datatype):
        assert isinstance(c, hdf5.Datatype) and c.dtype == h.dtype, path
        return
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
    _same(h[()], c[()], path, files)
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
    # every form is written to: an attribute on the group of dense links and
    # attributes, a dataset beside it; h5py lists both in their order
    with h5py.File(path, "r") as h:
        keys, attrs = list(h.keys()), list(h["many"].attrs.keys())
    with hdf5.File(path, "r+") as f:
        f["many"].attrs["x"] = "y"
        f.create_dataset("y", np.arange(3.0), contiguous=True)
    with h5py.File(path, "r") as h:
        assert list(h.keys()) == (keys + ["y"] if track else sorted(keys + ["y"]))
        assert list(h["many"].attrs.keys()) == (attrs + ["x"] if track else sorted(attrs + ["x"]))
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

    def records(read, addr, path, *sizes):
        depths.append(struct.unpack_from("<H", read(addr, 14), 12)[0])
        return real_records(read, addr, path, *sizes)

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
# version-4 layouts: every chunk index HDF5 writes at libver "latest"
# --------------------------------------------------------------------------

SHAPES = {1: ((23,), (4,)), 2: ((10, 7), (3, 2)), 3: ((6, 5, 4), (4, 2, 3))}
V4_INDEXES = {"single": "single chunk", "implicit": "implicit", "fixed": "fixed array",
              "fixed_paged": "fixed array", "extensible": "extensible array",
              "extensible_paged": "extensible array", "btree": "v2 B-tree"}
V4_CASES = [(index, flt, rank) for index in V4_INDEXES for flt in (None, "gzip", "lzf") for rank in (1, 2, 3)
            if not (index == "implicit" and flt)  # HDF5 keeps implicit chunks unfiltered
            and not (index == "btree" and rank == 1)  # two unlimited dims or more
            and not (index == "fixed_paged" and rank != 1) and not (index == "extensible_paged" and rank != 2)]


def _write_v4(path, index, flt, rank):
    """One dataset "v" under the chunk index ``index``; chunks through
    ``flt``; some chunks never written (the fill value) where the index
    allows it; a rank-3 filtered dataset's partial edge chunks stored
    unfiltered. Paged: a fixed array of 2,100 one-element chunks (three
    pages, the middle one never written), and an extensible array whose
    swizzled index reaches a paged data block (maxshape (70000, None))."""
    import ctypes

    shape, chunks = SHAPES[rank]
    maxshape = shape
    if index == "single":
        chunks = shape
    elif index == "implicit":
        maxshape = tuple(n + 2 for n in shape)
    elif index == "fixed_paged":
        shape = maxshape = (2100,)
        chunks = (1,)
    elif index == "extensible":
        maxshape = {1: (None,), 2: (10, None), 3: (6, None, 4)}[rank]  # (10, None): the index swizzled
    elif index == "extensible_paged":
        shape, maxshape, chunks = (1100, 3), (70_000, None), (1, 1)
    elif index == "btree":
        maxshape = (None,) * rank
    rng = np.random.default_rng(rank)
    data = np.round(rng.normal(size=shape), 3)
    filters = {None: (), "gzip": (lambda d: d.set_shuffle(), lambda d: d.set_deflate(5)),
               "lzf": (lambda d: d.set_filter(32000, h5py.h5z.FLAG_OPTIONAL, ()),)}[flt]

    def dcpl_fn(d):
        if index == "implicit":
            d.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        if flt and rank == 3:
            FX._hdf5_call("H5Pset_chunk_opts", ctypes.c_int64(d.id), ctypes.c_uint(FX.DONT_FILTER_PARTIAL_CHUNKS))

    with h5py.File(path, "w", libver="latest") as f:
        v = FX._variable(f, "v", [], dcpl_fn=dcpl_fn, shape=shape, maxshape=maxshape, chunks=chunks, dtype="f8",
                         fillvalue=-4.5, filters=filters)
        if index == "single":
            v[...] = data
        elif index == "fixed_paged":
            v[:900], v[2050] = data[:900], data[2050]
        elif index == "extensible_paged":
            v[:276, 2], v[1000, 2], v[5:9, 0] = data[:276, 2], data[1000, 2], data[5:9, 0]
        else:
            v[chunks[0]:] = data[chunks[0]:]  # the first row of chunks never written
        assert FX.chunk_index_type(v) == V4_INDEXES[index]


@pytest.mark.parametrize("index,flt,rank", V4_CASES, ids=[f"{i}-{f or 'raw'}-{r}d" for i, f, r in V4_CASES])
def test_version4_chunk_indexes_read_as_h5py(index, flt, rank, tmp_path):
    path = str(tmp_path / "v4.h5")
    _write_v4(path, index, flt, rank)
    assert _same_as_h5py(path) == 3


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
       layout=st.sampled_from(["contiguous", "chunked", "gzip"]), seed=st.integers(0, 2**16),
       libver=st.sampled_from(["earliest", "latest"]), unlimited=st.integers(0, 3))
def test_round_trip_property(dtype, shape, layout, seed, libver, unlimited, tmp_path):
    # any of these dtypes, shapes and layouts written by h5py under either
    # library-version bound reads back through the codec as h5py reads it;
    # at "latest" the chunk index follows the unlimited dims (none: a fixed
    # array or a single chunk; one: an extensible array; more: a v2 B-tree)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 100, shape).astype(dtype) if np.dtype(dtype).kind != "f" else rng.normal(size=shape)
    data = np.asarray(data, dtype=dtype)
    path = str(tmp_path / f"p{seed}.h5")
    kw = {}
    if layout != "contiguous" and len(shape) and all(shape):
        kw = {"chunks": tuple(max(1, n // 2) for n in shape), **({"compression": "gzip"} if layout == "gzip" else {}),
              "maxshape": tuple(None if i < unlimited else n for i, n in enumerate(shape))}
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("v", data=data, **kw)
    assert _same_as_h5py(path) == (3 if libver == "latest" else 0)


# --------------------------------------------------------------------------
# h5py's lzf filter, committed datatypes and user blocks
# --------------------------------------------------------------------------


def _lzf_chunks(path, name):
    """The stored bytes of every chunk of ``name`` that went through lzf, and
    the bytes h5py reads for it."""
    out = []
    with h5py.File(path, "r") as h:
        ds = h[name]
        for i in range(ds.id.get_num_chunks()):
            info = ds.id.get_chunk_info(i)
            mask, blob = ds.id.read_direct_chunk(info.chunk_offset)
            if not mask:
                sl = tuple(slice(o, o + c) for o, c in zip(info.chunk_offset, ds.chunks))
                block = np.full(ds.chunks, 0, ds.dtype)
                part = ds[sl]
                block[tuple(slice(0, n) for n in part.shape)] = part
                out.append((blob, block.tobytes()))
    return out


def test_lzf_native_and_python_decoders_agree(tmp_path):
    # the C++ loop and the plain Python one give the same bytes, and h5py's,
    # on the fixture's chunks and on chunks of long, overlapping and far
    # matches; both refuse a stream that overflows or points before its start
    path = str(tmp_path / "lzf.h5")
    rng = np.random.default_rng(11)
    with h5py.File(path, "w") as f:
        runs = np.repeat(rng.integers(0, 5, 400), rng.integers(1, 300, 400))[:60_000].astype(np.uint8)
        f.create_dataset("runs", data=runs, chunks=(20_000,), compression="lzf")
        text = np.frombuffer((b"the quick brown fox " * 3000)[:50_000], np.uint8)
        f.create_dataset("text", data=text, chunks=(25_000,), compression="lzf")
    chunks = [c for name in ("runs", "text") for c in _lzf_chunks(path, name)]
    chunks += [c for name in ("z", "u") for c in _lzf_chunks(str(FX_DIR / "v4_lzf.nc"), name)]
    assert len(chunks) >= 18
    for blob, want in chunks:
        native = lzf_decode(blob, len(want))
        assert native == lzf_decode(blob, len(want), decoder="python") == want
    blob, want = chunks[0]
    for decoder in ("native", "python"):
        with pytest.raises(ValueError, match="corrupt lzf"):
            lzf_decode(blob, len(want) - 1, decoder=decoder)
        with pytest.raises(ValueError, match="corrupt lzf"):
            lzf_decode(b"\x20\x05", 16, decoder=decoder)  # a match before the first byte


def test_lzf_reads_raise_when_the_host_library_does_not_build(tmp_path, monkeypatch):
    # no fallback to the Python loop: the codec raises as the build does (a
    # file of superblock 0, whose metadata carries no checksums)
    from gpsat_tpu_torch import native

    path = str(tmp_path / "lzf.h5")
    with h5py.File(path, "w") as h:
        h.create_dataset("z", data=np.zeros(64), chunks=(16,), compression="lzf")

    def no_build():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "library", no_build)
    with hdf5.File(path, "r") as f:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            f["z"][()]


@pytest.mark.parametrize("length", [*range(41), 4096 + 7])
def test_lookup3_native_and_python_agree(length):
    # the host library's lookup3, which the codec's checksums run, against
    # the plain Python one: every tail length of the last 12-byte block,
    # several blocks, and a long buffer; two initial values
    from gpsat_tpu_torch import native

    data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    for initval in (0, 0x9E3779B9):
        assert native.lookup3(data, initval) == hdf5_structures.lookup3(data, initval)


def test_chunk_rows_sets_a_written_column_chunks(tmp_path):
    # create_dataset's chunk_rows gives the column those chunks (h5py reads
    # them back); without it the chunks are h5py's guess; below 1 it raises
    path = str(tmp_path / "c.h5")
    rows = np.arange(1000, dtype=np.int32)
    with hdf5.File(path, "w") as f:
        f.create_dataset("one", rows, chunk_rows=1)
        f.create_dataset("seven", rows, chunk_rows=7)
        f.create_dataset("guess", rows)
        with pytest.raises(ValueError, match="chunk_rows"):
            f.create_dataset("zero", rows, chunk_rows=0)
    with h5py.File(path, "r") as h:
        assert h["one"].chunks == (1,) and h["seven"].chunks == (7,)
        assert h["guess"].chunks == (hdf5.guess_chunk_rows(1000, 4),)
        for k in ("one", "seven", "guess"):
            np.testing.assert_array_equal(h[k][()], rows)


@pytest.mark.parametrize("libver", ["earliest", "v108", "latest"])
def test_committed_datatypes_read_as_h5py(libver, tmp_path):
    # enum, compound and vlen types committed as netCDF-C commits them, used
    # by datasets and attributes; the types themselves read as h5py's
    # Datatype objects
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver=FX.LIBVER.get(libver, libver), track_order=libver != "earliest") as f:
        f["enum_t"] = h5py.enum_dtype({"LOW": 0, "MID": 1, "HIGH": 2}, "i1")
        f["cmp_t"] = np.dtype([("a", "<i4"), ("b", ">f8"), ("c", "S3")])
        f["vlen_t"] = h5py.vlen_dtype(np.dtype("<i2"))
        f["enum_t"].attrs["note"] = "committed"
        f.create_dataset("e", data=np.array([0, 2, 1, 1], "i1"), dtype=f["enum_t"], chunks=(2,), compression="gzip")
        f.create_dataset("c", data=np.array([(1, 2.5, b"ab"), (3, 4.5, b"xyz")], f["cmp_t"].dtype), dtype=f["cmp_t"])
        v = f.create_dataset("v", (3,), dtype=f["vlen_t"])
        v[0], v[2] = np.arange(3, dtype="i2"), np.arange(5, dtype="i2")
        f["e"].attrs.create("ae", np.array([2, 0], "i1"), dtype=f["enum_t"])
        f["e"].attrs.create("ac", np.array([(7, 8.5, b"q")], f["cmp_t"].dtype), dtype=f["cmp_t"])
        av = np.empty(2, object)
        av[0], av[1] = np.arange(2, dtype="i2"), np.arange(4, dtype="i2")
        f.attrs.create("av", av, dtype=f["vlen_t"])
    _same_as_h5py(path)
    with hdf5.File(path, "r") as f:
        assert h5py.check_enum_dtype(f["e"].dtype) == {"LOW": 0, "MID": 1, "HIGH": 2}
        assert h5py.check_enum_dtype(f["enum_t"].dtype) == {"LOW": 0, "MID": 1, "HIGH": 2}


@pytest.mark.parametrize("size", [512, 4096])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_user_block_files_read_as_h5py(libver, size, tmp_path):
    # every address relative to the superblock past the user block; the
    # file also written to, which h5py reads with its user block
    path = str(tmp_path / "ub.h5")
    with h5py.File(path, "w", libver=libver, userblock_size=size) as f:
        f.create_dataset("c", data=np.arange(100), chunks=(7,), maxshape=(None,))
        f.create_dataset("x", data=np.arange(10.0))
        f.attrs["a"] = "text"
    with open(path, "r+b") as fh:
        fh.write(b"a user's block")
    assert _same_as_h5py(path) == (3 if libver == "latest" else 0)
    with hdf5.File(path, "r+") as f:
        f["c"].append(np.arange(5))
        f.create_dataset("y", np.arange(3.0), contiguous=True)
        f.attrs["b"] = "more"
    with h5py.File(path, "r") as h:
        assert h.userblock_size == size and h.attrs["b"] == "more"
        np.testing.assert_array_equal(h["c"][()], np.r_[np.arange(100), np.arange(5)])
    assert Path(path).read_bytes()[:14] == b"a user's block"
    _same_as_h5py(path)


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


@pytest.mark.parametrize("name", [FX.V4_RESULTS, *FX.V4_NETCDF])
def test_later_format_fixtures_match_h5py_and_jax_readers(name):
    # the version-4, lzf, committed-type and user-block fixtures: every
    # object as h5py reads it, and each frame as the JAX reader gives it
    path = str(FX_DIR / name)
    _same_as_h5py(path)
    if name == FX.V4_RESULTS:
        assert TPT.list_tables(path) == JPT.list_tables(path)
        for key in ("lengthscales", "kernel_variance", "likelihood_variance"):
            pd.testing.assert_frame_equal(TPT.read_table(path, key), JPT.read_table(path, key))
        return
    variables = FX.V4_NETCDF[name][1]
    for decode_cf in (True, False):
        pd.testing.assert_frame_equal(TN.read_netcdf(path, variables=variables, decode_cf=decode_cf),
                                      JN.read_netcdf(path, variables=variables, decode_cf=decode_cf))


def test_netcdf_reader_passes_over_committed_datatypes(tmp_path):
    # netCDF-C commits a user-defined type in the root group: the port's
    # reader lists the variables only (the JAX reader fails on the type
    # unless told which variables to read)
    path = str(tmp_path / "enum.nc")
    with h5py.File(path, "w", libver=("v108", "v108"), track_order=True) as f:
        x = f.create_dataset("x", data=np.arange(4.0))
        x.make_scale("x")
        f["flag_t"] = h5py.enum_dtype({"A": 0, "B": 1}, "u1")
        f.create_dataset("flag", data=np.array([0, 1, 1, 0], "u1"), dtype=f["flag_t"]).dims[0].attach_scale(x)
    pd.testing.assert_frame_equal(TN.read_netcdf(path), JN.read_netcdf(path, variables=["flag"]))
    with pytest.raises(AttributeError):
        JN.read_netcdf(path)


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


def _case_file(path, kind):
    """The file of a refusal or a read case: ``v`` the object it is about."""
    import ctypes

    data = np.arange(40.0)
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    if kind in ("four_byte_offsets", "two_byte_offsets"):
        fcpl.set_sizes(*((4, 4) if kind == "four_byte_offsets" else (2, 2)))
    if kind == "user_block":
        fcpl.set_userblock(512)
    if kind in ("shared_datatype_table", "shared_dataspace"):  # one index of the shared-message table
        fid = ctypes.c_int64(fcpl.id)
        FX._hdf5_call("H5Pset_shared_mesg_nindexes", fid, ctypes.c_uint(1))
        FX._hdf5_call("H5Pset_shared_mesg_index", fid, ctypes.c_uint(0),
                      ctypes.c_uint(0x0008 if kind == "shared_datatype_table" else 0x0002), ctypes.c_uint(0))
    if kind in ("paged_file", "persisted_free_space"):
        paged = kind == "paged_file"
        fcpl.set_file_space_strategy(h5py.h5f.FSPACE_STRATEGY_PAGE if paged else h5py.h5f.FSPACE_STRATEGY_FSM_AGGR,
                                     not paged, 1)
        if paged:
            fcpl.set_file_space_page_size(4096)
    latest = kind.startswith("layout_v4") or kind in ("superblock_checksum", "virtual_dataset", "earray_checksum",
                                                      "filtered_fractal_heap", "superblock_writer_flag",
                                                      "paged_file", "persisted_free_space", "virtual_unlimited",
                                                      "virtual_printf")
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(*((h5py.h5f.LIBVER_LATEST,) * 2 if latest else (h5py.h5f.LIBVER_EARLIEST,
                                                                            h5py.h5f.LIBVER_LATEST)))
    with h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl)) as f:
        if kind == "fletcher32_mismatch":
            f.create_dataset("v", data=data, chunks=(8,), fletcher32=True)
        elif kind == "layout_v4_extensible_array":
            f.create_dataset("v", data=data, chunks=(8,), maxshape=(None,))
        elif kind == "unencodable_filter_append":
            f.create_dataset("v", data=data, chunks=(8,), maxshape=(None,), scaleoffset=3)
        elif kind == "blosclz_append":  # blosc's default compressor, which the codec decodes and does not encode
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((8,))
            dcpl.set_filter(FX.BLOSC_ID, h5py.h5z.FLAG_OPTIONAL, (2, 2, 8, 64, 5, 1, 0))
            ds = h5py.Dataset(h5py.h5d.create(f.id, b"v", h5py.h5t.IEEE_F64LE,
                                              h5py.h5s.create_simple((40,), (h5py.h5s.UNLIMITED,)), dcpl=dcpl))
            for lo in range(0, 40, 8):
                ds.id.write_direct_chunk((lo,), blosc_encode(data[lo:lo + 8].tobytes(), 8, cname="lz4"))
        elif kind == "committed_datatype_attribute":
            f["v"] = np.dtype("f8")
        elif kind == "earray_checksum":  # past the index block's four elements: a data block
            f.create_dataset("v", data=data, chunks=(2,), maxshape=(None,))
        elif kind == "layout_v4_fixed_array":
            f.create_dataset("v", data=data, chunks=(8,))
        elif kind in ("unknown_filter_lzf", "unknown_applied_filter"):
            f.create_dataset("v", data=data, chunks=(8,), compression="lzf")
        elif kind == "region_reference":
            f.create_dataset("x", data=data)
            r = f.create_dataset("v", (1,), dtype=h5py.regionref_dtype)
            r[0] = f["x"].regionref[1:3]
        elif kind == "committed_datatype":
            f["t"] = np.dtype("f8")
            f.create_dataset("v", data=data, dtype=f["t"])
        elif kind == "virtual_dataset":
            f.create_dataset("x", data=data)
            layout = h5py.VirtualLayout(shape=(40,), dtype="f8")
            layout[:] = h5py.VirtualSource(f["x"])
            f.create_virtual_dataset("v", layout)
        elif kind in ("virtual_unlimited", "virtual_printf"):  # over x as it grows; over files src-0.h5, src-1.h5 ...
            unlimited = h5py.h5s.UNLIMITED
            f.create_dataset("x", data=data, maxshape=(None,), chunks=(8,))
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            vspace = h5py.h5s.create_simple((40,), (unlimited,))
            if kind == "virtual_unlimited":
                vspace.select_hyperslab((0,), (1,), block=(unlimited,))
                sspace = h5py.h5s.create_simple((40,), (unlimited,))
                sspace.select_hyperslab((0,), (1,), block=(unlimited,))
                dcpl.set_virtual(vspace, b".", b"/x", sspace)
            else:
                vspace.select_hyperslab((0,), (unlimited,), stride=(10,), block=(10,))
                dcpl.set_virtual(vspace, b"src-%b.h5", b"/x", h5py.h5s.create_simple((10,)))
            h5py.h5d.create(f.id, b"v", h5py.h5t.IEEE_F64LE, vspace, dcpl=dcpl)
        elif kind == "external_storage":
            f.create_dataset("v", data=data, external=[(path + ".raw", 0, h5py.h5f.UNLIMITED)])
        elif kind in ("shared_datatype_table", "shared_dataspace"):  # the second user of a message shares it
            rec = np.zeros(40, [("a", "<i4"), ("b", "<f8")])
            f.create_dataset("x", data=rec)
            f.create_dataset("v", data=rec)
        elif kind == "filtered_fractal_heap":  # a group's dense links, deflated
            gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
            gcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED)
            FX._hdf5_call("H5Pset_deflate", ctypes.c_int64(gcpl.id), ctypes.c_uint(5))
            h5py.h5g.create(f.id, b"v", gcpl=gcpl)
            for i in range(30):
                f["v"].create_group(f"link_{i:03d}")
        else:
            f.create_dataset("v", data=data)
    if kind == "fletcher32_mismatch":
        _flip_chunk_byte(path, "v")
    if kind == "superblock_writer_flag":  # as a writer that did not close the file leaves it
        raw = bytearray(Path(path).read_bytes())
        raw[11] |= 0x01
        raw[44:48] = struct.pack("<I", hdf5_structures.lookup3(bytes(raw[:44])))
        Path(path).write_bytes(bytes(raw))
    if kind == "superblock_checksum":
        with open(path, "r+b") as fh:
            fh.seek(28)  # the end-of-file address
            fh.write(struct.pack("<Q", 1 << 40))
    if kind == "unknown_applied_filter":  # the pipeline names lz4 (32004), which the chunks did go through
        with hdf5.File(path, "r") as f:
            body = [b for t, _, b, _ in hdf5._read_header(f, f["v"]._addr)[2] if t == hdf5.FILTERS][0]
        raw = Path(path).read_bytes()
        assert body[0] == 1 and raw.count(body) == 1  # a version-1 pipeline: the first id at offset 8
        Path(path).write_bytes(raw.replace(body, body[:8] + struct.pack("<H", 32004) + body[10:]))
    if kind == "earray_checksum":
        raw = bytearray(Path(path).read_bytes())
        at = raw.index(b"EADB") + 20  # an element's byte
        raw[at] ^= 0xFF
        Path(path).write_bytes(bytes(raw))


REFUSALS = {
    "fletcher32_mismatch": "fletcher32 checksum mismatch",
    "unknown_applied_filter": r"filter 32004 \(lzf\) is not one this codec applies",
    "superblock_checksum": "checksum of the superblock",
    "earray_checksum": "checksum of the extensible array data block",
    "virtual_unlimited": r"an unlimited mapping of \.:/x; this codec reads fixed mappings",
    "virtual_printf": "a printf-style source file name 'src-%b.h5'",
    "two_byte_offsets": "2-byte offsets and 2-byte lengths; this codec reads 4- and 8-byte ones",
}
# what the codec reads and does not write: refused when the file is opened
# to write, or when the object is changed, before a byte is written
WRITE_REFUSALS = {
    "four_byte_offsets_write": "4-byte offsets and 4-byte lengths; this codec opens such a file to read only",
    "external_append": "is stored in external files; this codec reads it and does not append to it",
    "virtual_append": "is a virtual dataset; this codec reads it and does not append to it",
    "superblock_writer_flag": "file-consistency flags 0x01: a writer has the file open",
    "paged_file": "a paged file-space strategy",
    "persisted_free_space": "a persisted free-space manager",
    "shared_table_write": "a shared-object-header-message table in the superblock extension",
    "unencodable_filter_append": r"filter 6 \(scaleoffset\) has no encoder in this codec",
    "blosclz_append": r"filter 32001 \(blosc\) with compressor code 0: this codec's blosc encoder",
    "committed_datatype_attribute": "is a committed datatype; this codec reads it and does not write it",
}


# the file of a write refusal, where it is a read case's
WRITE_CASE_FILES = {"shared_table_write": "shared_datatype_table", "four_byte_offsets_write": "four_byte_offsets",
                    "external_append": "external_storage", "virtual_append": "virtual_dataset"}


@pytest.mark.parametrize("kind", sorted(REFUSALS) + sorted(WRITE_REFUSALS))
def test_codec_names_what_it_refuses(kind, tmp_path):
    path = str(tmp_path / "r.h5")
    _case_file(path, WRITE_CASE_FILES.get(kind, kind))
    before = Path(path).read_bytes()
    with pytest.raises(hdf5.FormatError, match={**REFUSALS, **WRITE_REFUSALS}[kind]):
        if kind in WRITE_REFUSALS:
            with hdf5.File(path, "r+") as f:
                if kind == "committed_datatype_attribute":
                    f["v"].attrs["x"] = 1.0
                else:
                    f["v"].append(np.arange(3.0))
        with hdf5.File(path, "r") as f:
            if kind == "filtered_fractal_heap":
                f["v"].keys()
            else:
                f["v"][()]
    assert Path(path).read_bytes() == before
    if kind in ("paged_file", "persisted_free_space", "committed_datatype_attribute", *WRITE_CASE_FILES):
        _same_as_h5py(path)  # and it reads as h5py reads it


# what the codec refused before it read version-4 layouts, lzf, committed
# datatypes and user blocks, and then the shared-message table, filtered
# fractal heaps, 4-byte offsets, external and virtual storage and region
# references: each file's superblock version
FORMERLY_REFUSED = {"layout_v4_extensible_array": 3, "layout_v4_fixed_array": 3, "unknown_filter_lzf": 0,
                    "committed_datatype": 0, "user_block": 0, "shared_datatype_table": 2, "shared_dataspace": 2,
                    "filtered_fractal_heap": 3, "four_byte_offsets": 0, "external_storage": 0, "virtual_dataset": 3,
                    "region_reference": 0}


@pytest.mark.parametrize("kind", list(FORMERLY_REFUSED))
def test_formerly_refused_files_read_as_h5py(kind, tmp_path):
    path = str(tmp_path / "r.h5")
    _case_file(path, kind)
    assert _same_as_h5py(path) == FORMERLY_REFUSED[kind]
    with hdf5.File(path, "r") as f:
        if kind == "region_reference":  # x[1:3], through the reference
            ref = f["v"][0]
            np.testing.assert_array_equal(f[ref][ref], np.arange(40.0)[1:3])
        elif kind == "filtered_fractal_heap":
            assert f["v"].keys() == [f"link_{i:03d}" for i in range(30)]
        elif kind.startswith("shared_"):
            np.testing.assert_array_equal(f["v"][()], np.zeros(40, [("a", "<i4"), ("b", "<f8")]))
        else:
            np.testing.assert_array_equal(f["v"][()], np.arange(40.0))
