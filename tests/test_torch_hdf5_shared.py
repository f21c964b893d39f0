"""The port's HDF5 codec (gpsat_tpu_torch/data/hdf5.py) on the files it read
last: the shared-object-header-message table (every message type HDF5
shares, a list index and a version-2 B-tree index, dense attributes),
fractal heaps with I/O filters (an indirect root, a huge object), 4-byte
offsets and lengths under superblocks 0, 2 and 3, external storage by
absolute and relative name, virtual datasets (same file, other files,
missing sources; the selection encodings of versions 1 to 3) and region
references. Every file is written here by h5py and read through the port,
held to h5py; netCDF-shaped ones also to the JAX package's h5py reader
(``gpsat_tpu.data.netcdf.read_netcdf``); and chip_smoke.py phase 17 (i)'s
virtual observations file to the rows it maps. No JAX program is
compiled."""

import os
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gpsat_tpu.data import netcdf as JN
from gpsat_tpu_torch.data import hdf5
from gpsat_tpu_torch.data import hdf5_structures
from gpsat_tpu_torch.data import netcdf as TN
from test_torch_hdf5_formats import CS, FX, _same_as_h5py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other port tests pin it under tier-1's
    six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the shared-object-header-message table
# --------------------------------------------------------------------------

# message types: dataspace, datatype, fill value (new and old), filter pipeline, attribute
SHARED_MESSAGE_TYPES = {hdf5.DATASPACE, hdf5.DATATYPE, hdf5.FILL, hdf5.FILL_OLD, hdf5.FILTERS, hdf5.ATTRIBUTE}


def _shared_objects(f):
    """Objects whose messages repeat, so that HDF5 shares them: three chunked
    compound datasets through the same filters and fill value, attributes
    alike on each, a group of 12 attributes (dense), a variable-length
    string dataset and attribute, a committed datatype beside them."""
    rec = np.zeros(40, [("a", "<i4"), ("b", "<f8")])
    rec["a"], rec["b"] = np.arange(40), np.arange(40) / 8
    for name in ("x", "y", "z"):
        ds = f.create_dataset(name, data=rec, chunks=(8,), compression="gzip", shuffle=True, fillvalue=rec[3])
        ds.attrs["units"] = np.arange(3.0)
        ds.attrs["note"] = "shared"
    g = f.create_group("dense")
    for i in range(12):
        g.attrs[f"a{i:02d}"] = np.arange(4.0) + (i % 3)
    f.create_dataset("s", data=np.array(["p", "qé", ""], dtype=object), dtype=h5py.string_dtype())
    f["t"] = np.dtype("<i2")
    f.create_dataset("u", data=np.arange(6, dtype="<i2"), dtype=f["t"])


@pytest.mark.parametrize("index", ["list", "btree", "per_type"])
def test_shared_message_table_reads_as_h5py(index, tmp_path, monkeypatch):
    # every message type shared from 0 bytes up: one index kept a list, one a
    # B-tree from its first message, one index per type; the dense group's
    # attributes in the shared-message heap, its B-tree records flagged
    path = tmp_path / "sohm.h5"
    with FX.create_file(path, fcpl_fn=lambda p: FX.shared_table(p, index)) as f:
        _shared_objects(f)
    raw = path.read_bytes()
    assert (b"SMLI" in raw) == (index != "btree")
    resolved = []
    real = hdf5.File._sohm_heap

    def heap(self, mtype, what):
        resolved.append(mtype)
        return real(self, mtype, what)

    monkeypatch.setattr(hdf5.File, "_sohm_heap", heap)
    assert _same_as_h5py(str(path)) == 2
    assert set(resolved) == SHARED_MESSAGE_TYPES, sorted(set(resolved))
    with hdf5.File(str(path), "r") as f:
        assert len(f._sohm) == (5 if index == "per_type" else 1)
        assert f["dense"]._attr_dense


# --------------------------------------------------------------------------
# fractal heaps with I/O filters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("filters", ["deflate", "deflate_fletcher32"])
def test_filtered_fractal_heap_reads_as_h5py(filters, tmp_path):
    # a group's dense links through the group's filters: 300 long names (an
    # indirect root of many direct blocks, each filtered, its size and mask
    # in the indirect block) and one name of 5,000 bytes (a huge object,
    # filtered, under the heap's B-tree of type 2)
    path = str(tmp_path / "heap.h5")
    with h5py.File(path, "w", libver="latest") as f:
        gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
        gcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED)
        FX.link_filters(gcpl, filters)
        h5py.h5g.create(f.id, b"g", gcpl=gcpl)
        for i in range(300):
            f["g"].create_group(f"link_{(i * 7) % 300:03d}_" + "n" * 40)
        f["g"].create_group("L" * 5000)
        f["g"]["L" * 5000].attrs["huge"] = np.int64(1)
    assert _same_as_h5py(path) == 3
    with hdf5.File(path, "r") as f:
        g = f["g"]
        heap = hdf5.FractalHeap(f._read, f._addr(g._link_info[1], 10), f.path)
        assert [flt.id for flt in heap.filters] == ([1] if filters == "deflate" else [1, 3])
        assert len(heap._blocks) > 4 and all(b[3] < b[2] for b in heap._blocks)  # stored smaller than the block
        assert len(heap._huge_records()) == 1


# --------------------------------------------------------------------------
# 4-byte offsets and lengths
# --------------------------------------------------------------------------


def _objects_of_every_kind(f, unlimited=True):
    """What the codec reads, so that every address and length is met: 20
    datasets in the root (symbol-table nodes or dense links), chunked data
    under a B-tree of depth 2 or a version-4 index (fixed and extensible
    arrays where ``unlimited``, a version-2 B-tree), filtered chunks,
    chunks never written, compact and contiguous data, a group of 12
    attributes (dense), strings, object references, dimension scales, a
    soft link and a committed datatype. (Region references are held to
    h5py in their own tests: HDF5 1.14.6 cannot read back, under 4-byte
    sizes, those it writes after other global heap objects.)"""
    rng = np.random.default_rng(4)
    for i in range(20):
        f.create_dataset(f"d{(i * 7) % 20:02d}", data=np.arange(i + 1, dtype="<i4"))
    f.create_dataset("chunked", data=rng.normal(size=(100, 7)), chunks=(1, 7),
                     maxshape=(None, 7) if unlimited else None, compression="gzip")
    f.create_dataset("fixed", data=np.arange(50.0), chunks=(4,))
    grid = f.create_dataset("grid", shape=(9, 8), chunks=(2, 3), maxshape=(None, None), dtype="<i8", fillvalue=-3)
    grid[:4, :5] = np.arange(20).reshape(4, 5)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I16LE, h5py.h5s.create_simple((5,)), dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, np.arange(5, dtype="<i2"))
    g = f.create_group("attrs")
    for i in range(12):
        g.attrs[f"a{i:02d}"] = np.arange(i + 1.0)
    g.attrs["text"] = "four bytes"
    f.create_dataset("strings", data=np.array(["a", "bb", "ccé"], dtype=object), dtype=h5py.string_dtype())
    x = f.create_dataset("x", data=np.arange(8.0))
    x.make_scale("x")
    v = f.create_dataset("v", data=np.arange(8.0) * 2)
    v.dims[0].attach_scale(x)
    refs = f.create_dataset("refs", (2,), dtype=h5py.ref_dtype)
    refs[0], refs[1] = x.ref, g.ref
    f["soft"] = h5py.SoftLink("/x")
    f["t"] = np.dtype("<f4")
    f.create_dataset("typed", data=np.arange(3, dtype="<f4"), dtype=f["t"])


FOUR_BYTE_CASES = [("earliest", 4, 4), ("v108", 4, 4), ("latest", 4, 4), ("earliest", 8, 4), ("latest", 4, 8)]


@pytest.mark.parametrize("libver,offsets,lengths", FOUR_BYTE_CASES, ids=[f"{lv}-{o}{s}" for lv, o, s in FOUR_BYTE_CASES])
def test_four_byte_offsets_read_as_h5py(libver, offsets, lengths, tmp_path):
    # HDF5 1.14.6 reopens no extensible array of 4-byte lengths: it reads
    # the unlimited dimension as 2^32 - 1, "didn't find unlimited dimension"
    path = str(tmp_path / "sizes.h5")
    with FX.create_file(path, libver, track_order=libver != "earliest",
                        fcpl_fn=lambda p: p.set_sizes(offsets, lengths)) as f:
        _objects_of_every_kind(f, unlimited=not (libver == "latest" and lengths == 4))
    assert _same_as_h5py(path) == {"earliest": 0, "v108": 2, "latest": 3}[libver]
    with hdf5.File(path, "r") as f:
        assert (f._so, f._sl) == (offsets, lengths)
        assert f["attrs"]._attr_dense == (libver != "earliest")  # a version-1 header keeps them all
        assert [f.deref(int(a)).name for a in f["refs"][()]] == ["/x", "/attrs"]


# --------------------------------------------------------------------------
# external storage
# --------------------------------------------------------------------------


def _external_files(names):
    """Two raw files, a.raw and b.raw, of known bytes; the slots of "v" [30]
    f8 (the first 8 rows past 16 bytes of a.raw, 10 more past 200, the
    rest from the start of b.raw) and "grow", extendible over an unlimited
    slot of b.raw past 512 bytes."""
    a, b = names
    return [(a, 16, 64), (a, 200, 80), (b, 0, 96)], [(b, 512, h5py.h5f.UNLIMITED)]


@pytest.mark.parametrize("naming", ["absolute", "relative"])
def test_external_storage_reads_as_h5py(naming, tmp_path, monkeypatch):
    # HDF5 looks for an external file as named, relative to the working
    # directory (no efile prefix): h5py and the codec read the same file from
    # the same working directory, and from another neither finds a relative
    # name's file
    monkeypatch.chdir(tmp_path)
    names = [str(tmp_path / n) if naming == "absolute" else n for n in ("a.raw", "b.raw")]
    for n in ("a.raw", "b.raw"):
        (tmp_path / n).write_bytes(np.random.default_rng(len(n)).integers(0, 256, 1024, dtype=np.uint8).tobytes())
    v_slots, grow_slots = _external_files(names)
    path = str(tmp_path / "ext.h5")
    with h5py.File(path, "w") as f:
        v = f.create_dataset("v", shape=(30,), dtype="<f8", external=v_slots)
        v[:20] = np.arange(20.0)  # the last ten rows keep b.raw's bytes
        grow = f.create_dataset("grow", shape=(4,), maxshape=(None,), dtype="<i4", external=grow_slots)
        grow[...] = np.arange(4)
        grow.id.set_extent((9,))  # h5py's resize takes chunked datasets only
        grow[4:] = np.arange(5) + 100
    assert _same_as_h5py(path) == 0
    (tmp_path / "elsewhere").mkdir()
    monkeypatch.chdir(tmp_path / "elsewhere")
    if naming == "absolute":
        assert _same_as_h5py(path) == 0
        return
    with h5py.File(path, "r") as h:
        with pytest.raises(OSError):
            h["v"][()]
    with hdf5.File(path, "r") as f:
        with pytest.raises(hdf5.FormatError, match="its external file 'a.raw' \\(slot 0\\) is not found"):
            f["v"][()]


# --------------------------------------------------------------------------
# virtual datasets
# --------------------------------------------------------------------------


def _write_vds(path, libver):
    """A virtual dataset "v" [4, 10] f8 over: "here" in the same file (all of
    it, a row), "a" of src.h5 named relative to the file (a strided
    hyperslab; i4 converted), "b" of sub/src2.h5 (a 2-D block), "c" of
    src.h5 named absolutely (two blocks together), a file and a dataset
    that do not exist (fill -9.5); and "vv", virtual over "v" of vds.h5."""
    src, sub = Path(path).parent / "src.h5", Path(path).parent / "sub"
    sub.mkdir(exist_ok=True)
    with h5py.File(src, "w") as s:
        s["a"] = np.arange(30, dtype="<i4") - 10
        s["c"] = np.arange(12.0).reshape(3, 4) / 3
    with h5py.File(sub / "src2.h5", "w") as s:
        s["b"] = np.arange(24.0).reshape(4, 6) + 0.25
    with h5py.File(path, "w", libver=libver) as f:
        f["here"] = np.arange(10.0) * -1
        layout = h5py.VirtualLayout(shape=(4, 10), dtype="f8")
        layout[0, :] = h5py.VirtualSource(".", "here", shape=(10,))
        layout[1, 0:10:2] = h5py.VirtualSource("src.h5", "a", shape=(30,))[3:28:5]
        layout[2:4, 1:4] = h5py.VirtualSource("sub/src2.h5", "b", shape=(4, 6))[1:3, 2:5]
        layout[1, 1:2] = h5py.VirtualSource("missing.h5", "a", shape=(1,))
        layout[2:4, 8:10] = h5py.VirtualSource("src.h5", "no_such", shape=(2, 2))
        f.create_virtual_dataset("v", layout, fillvalue=-9.5)
        FX._irregular_mapping(f["v"], str(src), "c", [((0, 0), (1, 2)), ((2, 3), (1, 1))],
                              [((3, 5), (1, 2)), ((0, 9), (1, 1))], file_name=str(src.resolve()))
    with h5py.File(Path(path).parent / "vv.h5", "w") as f:
        layout = h5py.VirtualLayout(shape=(10,), dtype="f8")
        layout[:] = h5py.VirtualSource(Path(path).name, "v", shape=(4, 10))[2, :]
        f.create_virtual_dataset("vv", layout)


@pytest.mark.parametrize("libver", ["earliest", "v110", "latest"])
def test_virtual_datasets_read_as_h5py(libver, tmp_path, monkeypatch):
    # the selections' encodings: version 1 (blocks) at "earliest", version 2
    # (regular, 8-byte) at "v110", version 3 at "latest"; the same from
    # another working directory, as both look in the file's directory first
    path = str(tmp_path / "vds.h5")
    _write_vds(path, libver)
    for where in (tmp_path, tmp_path / "sub"):
        monkeypatch.chdir(where)
        _same_as_h5py(path)
        _same_as_h5py(str(tmp_path / "vv.h5"))
    with hdf5.File(path, "r") as f:
        v = f["v"][()]
        mappings = f["v"]._virtual_mappings()
    assert v[1, 1] == -9.5 and np.all(v[2:4, 8:10] == -9.5) and v[1, 2] == 3 - 10 + 5
    assert len(mappings) == 6 and os.path.isabs(mappings[-1][0])
    # version 1 lists blocks; versions 2 and 3 keep a regular hyperslab's start, stride, count and block
    assert any(m[3].regular is not None for m in mappings) == (libver != "earliest")


def test_virtual_and_external_netcdf_matches_jax(tmp_path, monkeypatch):
    # a netCDF-shaped file whose variables lie elsewhere: "z" [6, 5] and
    # "count" [5] in an external file, "v" [12] and "w" [12, 5] virtual
    # (over a source file, the file itself and sources that are missing)
    monkeypatch.chdir(tmp_path)
    FX.write_external("ext.nc", "ext.raw")
    FX.write_virtual(str(tmp_path / "virt.nc"), "virt_src.h5")
    for name in ("ext.nc", "virt.nc"):
        for decode_cf in (True, False):
            pd.testing.assert_frame_equal(TN.read_netcdf(name, decode_cf=decode_cf),
                                          JN.read_netcdf(name, decode_cf=decode_cf))
    _same_as_h5py("ext.nc")
    _same_as_h5py("virt.nc")


def test_vds_obs_fixture_holds_phase_7_rows(tmp_path):
    # chip_smoke.py phase 17 (i)'s file: its granules written by the port's
    # writer, the fixture beside them; the port's read and the JAX reader's
    # (h5py reading the port's granules) give phase 7's rows exactly
    path = CS.vds_files(tmp_path)
    obs = CS.pipeline_inputs()[0]
    got, want = TN.read_netcdf(str(path)), JN.read_netcdf(str(path))
    pd.testing.assert_frame_equal(got, want)
    flat = got.reset_index()
    np.testing.assert_array_equal(flat["index"].to_numpy(), np.arange(len(obs["x"])))
    for c in ("x", "y", "z"):
        assert flat[c].dtype == np.float64
        np.testing.assert_array_equal(flat[c].to_numpy(), obs[c])
    FX.check_structure(Path(CS.FORMATS_DIR) / CS.FORMATS_VDS)


# --------------------------------------------------------------------------
# region references
# --------------------------------------------------------------------------


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_region_references_read_as_h5py(libver, tmp_path):
    # blocks, strides, two blocks together, points, all and none, in a
    # dataset and an attribute; dereferenced through f[ref] and ds[ref]
    path = str(tmp_path / "refs.h5")
    FX.write_region_refs(path, libver)
    _same_as_h5py(path)
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as f:
        pd.testing.assert_frame_equal(CS.region_frame(f, "refs"), CS.region_frame(h, "refs"))
        ref = f["refs"][()][0]
        assert f[ref].name == "/x" and f["x"][ref].shape == (2, 3)
        with pytest.raises(ValueError, match="names the object at"):
            f["y"][ref]
        assert f["x"].attrs["ref"].selection.kind == "hyperslabs"


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(shape=st.lists(st.integers(1, 6), min_size=1, max_size=3).map(tuple), seed=st.integers(0, 2**16),
       blocks=st.integers(1, 3), points=st.booleans(), libver=st.sampled_from(["earliest", "latest"]))
def test_region_reference_selections_property(shape, seed, blocks, points, libver, tmp_path):
    # any union of hyperslabs (start, stride, count, block) or list of points
    # over any shape: the elements and h5py's shape for them
    rng = np.random.default_rng(seed)
    path = str(tmp_path / f"p{seed}.h5")
    with h5py.File(path, "w", libver=libver) as f:
        ds = f.create_dataset("d", data=rng.normal(size=shape))
        sid = ds.id.get_space()
        if points:
            coords = np.stack([rng.integers(0, n, 1 + blocks * 2) for n in shape], axis=1)
            sid.select_elements(coords.astype(np.uint64))
        else:
            sid.select_none()
            for _ in range(blocks):
                count = tuple(int(rng.integers(1, 3)) for _ in shape)
                block = tuple(int(rng.integers(1, max(2, n // 2 + 1))) for n in shape)
                stride = tuple(b + int(rng.integers(0, 2)) for b in block)
                start = tuple(int(rng.integers(0, max(1, n - ((c - 1) * s + b) + 1)))
                              for n, c, s, b in zip(shape, count, stride, block))
                if all(st_ + (c - 1) * s + b <= n for st_, c, s, b, n in zip(start, count, stride, block, shape)):
                    sid.select_hyperslab(start, count, stride, block, op=h5py.h5s.SELECT_OR)
        f.create_dataset("r", (1,), dtype=h5py.regionref_dtype)[0] = h5py.h5r.create(
            ds.id, b".", h5py.h5r.DATASET_REGION, sid)
    with h5py.File(path, "r") as h, hdf5.File(path, "r") as f:
        want, got = h["d"][h["r"][0]], f["d"][f["r"][0]]
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


def test_fractal_heap_of_four_byte_sizes_matches_eight(tmp_path):
    # the same dense links under 4- and 8-byte sizes list the same names
    # through the heap's own walk (the header, indirect blocks and IDs at
    # each width)
    names = {}
    for offsets in (4, 8):
        path = str(tmp_path / f"h{offsets}.h5")
        with FX.create_file(path, "latest", fcpl_fn=lambda p: p.set_sizes(offsets, offsets)) as f:
            g = f.create_group("g")
            for i in range(200):
                g.create_group(f"name_{i:04d}_" + "x" * 30)
        with hdf5.File(path, "r") as f:
            names[offsets] = f["g"].keys()
            info = f["g"]._link_info[1]
            heap = hdf5_structures.FractalHeap(f._read, f._addr(info, 2), f.path, f._so, f._sl)
            assert len(heap._blocks) > 2
    assert names[4] == names[8] == sorted(names[8])
    assert os.path.getsize(tmp_path / "h4.h5") < os.path.getsize(tmp_path / "h8.h5")
