"""Writes through the port's HDF5 codec (gpsat_tpu_torch/data/hdf5.py) into
files that h5py wrote. The JAX package's TableStore over h5py makes a
results store under each library-version bound (superblocks 0 to 3, the
root tracking creation order or not, B-tree K values that are not HDF5's
defaults) with plain and filtered columns (gzip with shuffle, fletcher32,
lzf; blosc and bzip2, which h5py lacks, laid over its numeric columns by
write_direct_chunk). The same operations then run on two copies, one
through the JAX store and one through the port's: appends into the partly
filled last chunk and past it, a new table, a put that replaces a table,
put_attrs and the int -> float column promotion. Both readers give the
same frames from both copies, h5py lists keys and attributes in the same
order, and h5py then appends to the port's copy and the port reads that
exactly (h5py cannot decode blosc or bzip2 chunks: there the port's copy is
read by the port and held to the JAX copy's frames). Also: each filter's
encoder against its decoder, a refused write that commits nothing, a
partial edge chunk stored raw, tracked netCDF fixtures written to in
place, and the restart fixtures of chip_smoke.py phase 17 (h). No JAX
program is compiled."""

import importlib.util
import shutil
import struct
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from gpsat_tpu.data.store import TableStore as JStore
from gpsat_tpu_torch.data import hdf5
from gpsat_tpu_torch.data import hdf5_structures as HS
from gpsat_tpu_torch.data.lzf import lzf_decode
from gpsat_tpu_torch.data.store import TableStore as TStore

REPO = Path(__file__).resolve().parent.parent
FX_DIR = REPO / "tests" / "fixtures" / "hdf5"
_spec = importlib.util.spec_from_file_location("make_hdf5_fixtures", REPO / "tools" / "make_hdf5_fixtures.py")
FX = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(FX)
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other port tests pin it under tier-1's
    six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kinds(n, seed=0):
    """Every column kind a store holds, under a two-level index."""
    rng = np.random.default_rng(seed)
    idx = pd.MultiIndex.from_arrays([rng.normal(size=n), rng.integers(0, 3, n).astype(float)], names=["x", "y"])
    df = pd.DataFrame({
        "f8": rng.normal(size=n),
        "f4": rng.normal(size=n).astype(np.float32),
        "i8": rng.integers(-(1 << 40), 1 << 40, n),
        "ok": rng.random(n) > 0.5,
        "ns": np.datetime64("2020-03-01T00:00:00", "ns") + rng.integers(0, 10**15, n).astype("timedelta64[ns]"),
    }, index=idx)
    words = np.array(["sea ice", "glace de mer é", "", "морской лёд ❄"], dtype=object)
    df["s"] = pd.Series(words[rng.integers(0, len(words), n)], index=idx, dtype=object)
    return df


def _small(i, n=5):
    return pd.DataFrame({"a": np.arange(n, dtype=float) + n * i, "k": np.arange(n) + n * i})


# the store h5py writes: a table whose last chunk is partly filled (its
# chunk is the first write's 7 rows, then 5 more), an int column to promote,
# a table to replace, attributes; past 8 attributes a group keeps them in
# dense storage from libver v108 on ("t"'s then change, "p"'s do not)
INITIAL = [("append", "t", _kinds(7)), ("append", "t", _kinds(5, 1)),
           ("append", "p", pd.DataFrame({"v": np.array([1, 2, 3], dtype=np.int64), "w": [0.5, 1.5, 2.5]})),
           ("put", "u", _small(0)), ("attrs", "t", {"note": {"k": [1, 2]}, **{f"k{i}": i for i in range(8)}}),
           ("attrs", "p", {f"q{i}": [i] * i for i in range(9)})]
# then, on both copies: 2 rows into the partial chunk and 2 past it, several
# new chunks, a new table, a replaced table, attributes, the promotion
OPS = [("append", "t", _kinds(4, 2)), ("append", "t", _kinds(16, 3)), ("append", "n", _small(1)),
       ("put", "u", _small(2)), ("attrs", "t", {"more": "é", "k": 2}), ("attrs", "u", {"a": 1}),
       ("append", "p", pd.DataFrame({"v": [0.25], "w": [3.5]}))]
# and last, h5py's appends to both
AGAIN = [("append", "t", _kinds(3, 4)), ("append", "n", _small(3)), ("append", "p", pd.DataFrame({"v": [4.0],
                                                                                                 "w": [4.5]}))]

# id: (libver, column filters, create_h5py_store's settings, the superblock)
STORES = {
    "sb0": ("earliest", None, {}, 0),
    "sb0_tracked": ("earliest", None, {"track_order": True}, 0),
    "sb0_sym_k": ("earliest", None, {"sym_k": (8, 2)}, 0),
    "sb1": ("earliest", None, {"istore_k": 8}, 1),
    "sb1_gzip": ("earliest", "gzip", {"istore_k": 8}, 1),
    "sb2": ("v108", None, {}, 2),
    "sb2_gzip": ("v108", "gzip", {}, 2),
    "sb3": ("latest", None, {}, 3),
    "sb3_tracked": ("latest", None, {"track_order": True}, 3),
    "sb3_k_values": ("latest", None, {"istore_k": 8, "sym_k": (8, 2)}, 3),
    "sb3_gzip": ("latest", "gzip", {}, 3),
    "sb3_fletcher32": ("latest", "fletcher32", {}, 3),
    "sb3_lzf": ("latest", "lzf", {}, 3),
    "sb0_blosc": ("earliest", "blosc", {}, 0),
    "sb3_bzip2": ("latest", "bzip2", {}, 3),
}


def _apply(cls, path, ops):
    with cls(str(path), mode="a") as s:
        for op, table, arg in ops:
            if op == "append":
                s.append(table, arg)
            elif op == "put":
                s.put(table, arg)
            else:
                s.put_attrs(table, **arg)


def _contents(cls, path):
    with cls(str(path), mode="r") as s:
        return {t: (s.select(t), s.get_attrs(t)) for t in s.keys()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for t, (frame, attrs) in want.items():
        pd.testing.assert_frame_equal(got[t][0], frame, obj=t)
        assert got[t][1] == attrs, t


def _h5py_order(path):
    """Every object's attribute names and every group's keys, as h5py lists
    them."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = (list(f.attrs), list(f))

        def visit(name, obj):
            out[name] = (list(obj.attrs), list(obj) if isinstance(obj, h5py.Group) else None)

        f.visititems(visit)
    return out


def _make_store(path, libver, filters, settings):
    FX.create_h5py_store(path, libver, **settings)
    with FX.column_filters(filters if filters in FX.COLUMN_FILTERS else None):
        _apply(JStore, path, INITIAL)
    if filters in FX.DIRECT_FILTERS:
        FX.refilter_store(path, filters)


@pytest.mark.parametrize("store", sorted(STORES))
def test_port_writes_into_stores_h5py_wrote(store, tmp_path):
    libver, filters, settings, superblock = STORES[store]
    base, jax_copy, port_copy = tmp_path / "base.h5", tmp_path / "jax.h5", tmp_path / "port.h5"
    _make_store(base, libver, filters, settings)
    direct = filters in FX.DIRECT_FILTERS  # blosc, bzip2: the JAX copy is the same store unfiltered
    if direct:
        _make_store(jax_copy, libver, None, settings)
    else:
        shutil.copy(base, jax_copy)
    shutil.copy(base, port_copy)
    with hdf5.File(port_copy, "r") as f:
        assert f.superblock_version == superblock
    _apply(JStore, jax_copy, OPS)
    _apply(TStore, port_copy, OPS)
    with hdf5.File(port_copy, "r") as f:
        assert f.superblock_version == superblock
    want = _contents(JStore, jax_copy)
    _assert_same(_contents(TStore, port_copy), want)
    _assert_same(_contents(TStore, jax_copy), want)
    if not direct:
        _assert_same(_contents(JStore, port_copy), want)
    assert _h5py_order(port_copy) == _h5py_order(jax_copy)
    if store == "sb3":  # "p" carries its dense attributes (a version-2 header), "t"'s moved into a version-1 one
        with hdf5.File(port_copy, "r") as f:
            assert f["p"]._attr_dense and hdf5._read_header(f, f["p"]._addr)[0] == 2
            assert not f["t"]._attr_dense and hdf5._read_header(f, f["t"]._addr)[0] == 1
            assert f["t"]._stab and f["p"]._stab and len(f["t"].attrs.keys()) == 13
    if direct:  # h5py decodes neither: the port's chunks are held to the filter's own decoder
        with hdf5.File(port_copy, "r") as f:
            ds = f["t"]["f8"]
            offsets, addrs, sizes, masks = ds._chunk_index()
            assert ds._filters[0].id == FX.DIRECT_FILTERS[filters][0] and not masks.any()
            assert len(HS.unfilter(f._read(int(addrs[-1]), int(sizes[-1])), ds._filters, 0, 8, "", 7 * 8)) == 56
        return
    _apply(JStore, jax_copy, AGAIN)
    _apply(JStore, port_copy, AGAIN)
    want = _contents(JStore, jax_copy)
    _assert_same(_contents(TStore, port_copy), want)
    _assert_same(_contents(JStore, port_copy), want)


FILTER_SETS = {
    "deflate_shuffle": [(HS.SHUFFLE, 0, (8,)), (HS.DEFLATE, 1, (4,))],
    "fletcher32": [(HS.FLETCHER32, 0, ())],
    "lzf": [(HS.LZF, 1, (4, 261, 4096))],
    "bzip2": [(HS.BZIP2, 1, (9,))],
    "blosc_lz4": [(HS.BLOSC, 1, (2, 2, 8, 4096, 5, 1, 1))],
    "blosc_zlib_bitshuffle": [(HS.BLOSC, 1, (2, 2, 8, 4096, 5, 2, 4))],
    "shuffle_deflate_fletcher32": [(HS.SHUFFLE, 0, (8,)), (HS.DEFLATE, 1, (9,)), (HS.FLETCHER32, 0, ())],
}


@pytest.mark.parametrize("kind", sorted(FILTER_SETS))
def test_filter_encoders_invert_their_decoders(kind):
    rng = np.random.default_rng(3)
    raw = np.round(rng.normal(size=512), 2).tobytes()
    filters = [HS.Filter(fid, flags, "", client) for fid, flags, client in FILTER_SETS[kind]]
    blob, mask = HS.filter_chunk(raw, filters, 8)
    assert mask == 0 and HS.unfilter(blob, filters, 0, 8, kind, len(raw)) == raw
    if kind == "lzf":  # literal runs: both decoders read them, h5py's filter too (below)
        assert lzf_decode(blob, len(raw), "python") == lzf_decode(blob, len(raw)) == raw
        assert len(blob) == len(raw) + -(-len(raw) // 32)


def test_lzf_literals_at_run_boundaries():
    for n in (0, 1, 31, 32, 33, 64, 65):
        data = bytes(range(n))
        blob = HS._lzf_literals(data)
        assert lzf_decode(blob, n, "python") == data, n


def test_refused_write_commits_nothing(tmp_path):
    # a table of two columns, the second through scaleoffset (read by HDF5,
    # no encoder here): the append writes the first column, is refused at
    # the second, and the file is closed as it was opened
    path = tmp_path / "r.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("t")
        g.attrs["columns"], g.attrs["index_cols"] = '["a", "b"]', "[]"
        for name, kw in (("a", {}), ("b", {"scaleoffset": 0})):
            f.create_dataset(f"t/{name}", data=np.arange(5), maxshape=(None,), chunks=(4,), **kw)
            f[f"t/{name}"].attrs["dtype_tag"] = "<i8"
    before = _h5py_order(path), path.read_bytes()[:96]
    with pytest.raises(hdf5.FormatError, match=r"filter 6 \(scaleoffset\) has no encoder"):
        with TStore(str(path), mode="a") as s:
            s.append("t", pd.DataFrame({"a": [5, 6], "b": [5, 6]}))
    # the superblock and every header as they were: "a"'s rows went into its
    # last chunk past the dataset's end, and to the end of the file
    assert (_h5py_order(path), path.read_bytes()[:96]) == before
    with h5py.File(path, "r") as f:
        assert f["t/a"].shape == (5,) and f["t/b"].shape == (5,)
        np.testing.assert_array_equal(f["t/a"][()], np.arange(5))
    with hdf5.File(path, "r+") as f:
        f["t"]["a"].append(np.arange(2))
        with pytest.raises(hdf5.FormatError, match="scaleoffset"):
            f["t"]["b"].append(np.arange(2))
        with pytest.raises(hdf5.FormatError, match="this session's changes are not written"):
            f.flush()
    assert (_h5py_order(path), path.read_bytes()[:96]) == before


def test_partial_edge_chunk_stored_raw_is_filtered_once_filled(tmp_path):
    # a version-4 layout whose partial edge chunk HDF5 stored unfiltered
    # (H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS): carried over with every mask
    # bit set, then filled by an append and sent through the filters
    import ctypes

    path = tmp_path / "e.h5"
    with h5py.File(path, "w", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((8,))
        dcpl.set_shuffle()
        dcpl.set_deflate(4)
        FX._hdf5_call("H5Pset_chunk_opts", ctypes.c_int64(dcpl.id), ctypes.c_uint(FX.DONT_FILTER_PARTIAL_CHUNKS))
        dsid = h5py.h5d.create(f.id, b"v", h5py.h5t.IEEE_F64LE, h5py.h5s.create_simple((20,), (h5py.h5s.UNLIMITED,)),
                               dcpl=dcpl)
        dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(20.0))
        assert FX.chunk_index_type(f["v"]) == "extensible array"
    with hdf5.File(path, "r") as f:
        assert f["v"]._chunk_index()[3].tolist() == [0, 0, 0xFFFFFFFF]
    with hdf5.File(path, "r+") as f:
        f["v"].append(np.arange(20.0, 27.0))  # the edge chunk filled, three rows past it
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["v"][()], np.arange(27.0))
        masks = [f["v"].id.get_chunk_info(i).filter_mask for i in range(f["v"].id.get_num_chunks())]
        assert masks == [0, 0, 0, 0] and FX.chunk_index_type(f["v"]) == "v1 B-tree"
    with h5py.File(path, "a") as f:
        f["v"].resize((30,))
        f["v"][27:] = [27.0, 28.0, 29.0]
    with hdf5.File(path, "r") as f:
        np.testing.assert_array_equal(f["v"][()], np.arange(30.0))


def test_tail_of_a_new_chunk_holds_the_fill_value(tmp_path):
    path = tmp_path / "fill.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("v", data=np.arange(3.0), maxshape=(None,), chunks=(4,), fillvalue=-7.5)
    with hdf5.File(path, "r+") as f:
        f["v"].append(np.arange(3.0, 6.0))
    with h5py.File(path, "a") as f:
        f["v"].resize((8,))
        np.testing.assert_array_equal(f["v"][()], [0, 1, 2, 3, 4, 5, -7.5, -7.5])


def test_committed_type_datasets_keep_their_shared_type(tmp_path):
    # a variable of a committed enum type rewritten (an attribute added):
    # its header keeps the shared datatype message pointing at the type
    path = tmp_path / "c.nc"
    shutil.copy(FX_DIR / "nc_committed_types.nc", path)
    with h5py.File(path, "r") as h:
        want = h["flag"][()]
    with hdf5.File(path, "r+") as f:
        f["flag"].attrs["note"] = "kept"
    with h5py.File(path, "r") as h:
        assert h["flag"].id.get_type().committed() and h["flag"].attrs["note"] == "kept"
        assert h["flag"].dtype == h["flag_t"].dtype
        np.testing.assert_array_equal(h["flag"][()], want)


@pytest.mark.parametrize("name", ["nc_earliest_v108_tracked.nc", "nc_netcdf_c.nc", "nc_dense.nc"])
def test_tracked_fixtures_keep_their_order(name, tmp_path):
    # creation order tracked for links and attributes: a version-2 header
    # kept where attributes are tracked, link messages where links are;
    # what is added is listed last, dense links and attributes moved into
    # the header as h5py lists them
    path = tmp_path / name
    shutil.copy(FX_DIR / name, path)
    before = _h5py_order(path)
    with h5py.File(path, "r") as h:
        values = {k: h[k][()] for k in h if isinstance(h[k], h5py.Dataset)}
        var = next(k for k in h if isinstance(h[k], h5py.Dataset) and h[k].ndim == 3)
        tracked = [bool(o.id.get_create_plist().get_attr_creation_order() & h5py.h5p.CRT_ORDER_TRACKED)
                   for o in (h["/"], h[var])]
        links_tracked = bool(h["/"].id.get_create_plist().get_link_creation_order() & h5py.h5p.CRT_ORDER_TRACKED)
    with hdf5.File(path, "r+") as f:
        f.attrs["history"] = "appended"
        f[var].attrs["comment"] = "é"
        f.create_dataset("extra", np.arange(4.0), contiguous=True)
    after = _h5py_order(path)

    def added(names, name, in_order):
        return names + [name] if in_order else sorted(names + [name])

    assert after["/"] == (added(before["/"][0], "history", tracked[0]), added(before["/"][1], "extra", links_tracked))
    assert after[var] == (added(before[var][0], "comment", tracked[1]), None)
    assert tracked[0] and links_tracked
    assert {k: v for k, v in after.items() if k not in ("/", var, "extra")} == \
        {k: v for k, v in before.items() if k not in ("/", var)}
    with h5py.File(path, "a") as h:  # h5py goes on from the port's header: one more link and attribute
        h.attrs["after"] = 1
        h.create_group("later")
    with h5py.File(path, "r") as h:
        assert list(h.attrs) == after["/"][0] + ["after"] and list(h) == after["/"][1] + ["later"]
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as f:
        assert f.attrs.keys() == list(h.attrs) and f.keys() == list(h)
        for k, v in values.items():
            np.testing.assert_array_equal(h[k][()], v)
            got = f[k][()]
            if v.dtype == object:  # h5py gives a dataset's variable-length strings as bytes, the codec as str
                got, v = got.astype("U"), np.char.decode(v.astype("S"), "utf-8")
            np.testing.assert_array_equal(got, v)
        assert f.superblock_version == h.id.get_create_plist().get_version()[0]


@pytest.mark.parametrize("name", CS.FORMATS_RESTART_STORES)
def test_restart_fixtures_take_the_port_appends(name, tmp_path):
    # phase 17 (h)'s stores: the port appends the stored run_details rows
    # again; h5py reads them after the stored rows, which stay as they were
    path = tmp_path / name
    shutil.copy(FX_DIR / name, path)
    with h5py.File(path, "r") as h:
        filters = {h["preds"][c].compression for c in h["preds"]}
    assert filters == ({"gzip"} if "gzip" in name else {None})
    before = _contents(JStore, path)
    with TStore(str(path), mode="a") as s:
        s.append("run_details", before["run_details"][0])
    after = _contents(JStore, path)
    rd, rd_before = after["run_details"][0], before["run_details"][0]
    pd.testing.assert_frame_equal(rd.iloc[:len(rd_before)], rd_before)
    pd.testing.assert_frame_equal(rd.iloc[len(rd_before):], rd_before)
    assert struct.unpack("<B", path.read_bytes()[8:9])[0] in (2, 3)
