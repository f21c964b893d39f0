"""A reader and a writer of HDF5 files: it creates them in HDF5's earliest format.

Written in numpy and ``struct``; it needs no HDF5 library (lookup3 and
lzf run in the port's C++ host library). Section numbers below are those
of the HDF5 File Format Specification version 3.0. It reads what h5py
writes under every library-version bound, "latest" included, and the
PyTables and netCDF-C layouts as h5py reproduces them (the datatypes and
dataspaces in ``data/hdf5_types.py``; serialised selections in
``data/hdf5_selections.py``; checksums, filters, fractal heaps, version-2
B-trees and the version-4 chunk indexes in ``data/hdf5_structures.py``).
Files that PyTables, c-blosc or netCDF-C wrote themselves have not been
held to it: ``tests/fixtures/hdf5/MANIFEST.txt`` lists how the stand-ins
differ. It reads:

- superblocks of versions 0 to 3 (II.A) at offset 0 or past a user block
  (512, 1024, 2048 ... bytes), with addresses and lengths of 8 or 4 bytes
  (``H5Pset_sizes``) carried through every structure below, all ones the
  undefined address at either width; the checksum of versions 2 and 3
  checked;
- object headers of versions 1 and 2 (IV.A.1), continuation blocks
  followed, version 2's checksums checked;
- groups as symbol tables (a version-1 B-tree of type 0 over ``SNOD``
  nodes, names in a local heap; III.A.1, III.C, III.D) and new-style
  groups: link messages (IV.A.2.g) and, past a few links, a fractal heap
  of links under version-2 B-trees (IV.A.2.c); keys in name order, or in
  creation order where the group tracks it, as h5py gives them; soft and
  external links listed, not followed;
- attributes in the header (messages of versions 1 to 3) and in dense
  storage (IV.A.2.v: a fractal heap under a version-2 B-tree);
- shared messages: the shared-object-header-message table of the
  superblock extension (II.B, III.E ``SMTB``), its indexes (lists or
  version-2 B-trees) by the message types they share; a dataspace,
  datatype, fill value, filter pipeline or attribute shared in the
  table's fractal heap (a shared message of version 3, type 1), in the
  header or in dense storage; a message the index tracks but its one user
  keeps (stored in the header, flagged shareable) read as it stands;
- fractal heaps with I/O filters (III.G: a group created with filters
  keeps its dense links in one): each direct block and huge object
  through the heap's pipeline;
- compact, contiguous and chunked datasets (layout messages of versions 1
  to 4, IV.A.2.i): N-D chunks under the version-1 B-tree of type 1 or a
  version-4 index (a single chunk, implicit chunks, a fixed array, an
  extensible array, a version-2 B-tree of records 10 and 11), edge chunks
  cut to the dataset, chunks through the filter pipeline (deflate,
  shuffle, fletcher32, lzf, blosc, bzip2) as each chunk's filter mask
  says, partial edge chunks stored unfiltered where the layout says so,
  missing chunks as the fill value (IV.A.2.e, IV.A.2.f);
- external storage (IV.A.2.h): the data laid end to end across files
  named in a local heap, at each slot's offset, a relative name taken
  from the working directory as HDF5 takes it by default;
- virtual datasets (IV.A.2.i, layout class 3): each mapping's source
  selection copied into its virtual selection, the source file "." or
  looked for as HDF5 looks (absolute, the file's directory, the working
  directory), a missing file or dataset left as the fill value;
- datatypes stored in the header or committed (a shared datatype message
  pointing at a committed datatype's header), for datasets and
  attributes; committed datatypes themselves as ``Datatype`` objects;
- region references (datatype class 7, type 1) as ``RegionReference``
  values: ``file[ref]`` is the object, ``dataset[ref]`` the elements its
  selection (none, all, points, hyperslabs of encoding versions 1 to 3)
  picks, in h5py's order and shape;
- dimension scales (``Dataset.dims``, ``DIMENSION_LIST``'s object
  references resolved to the objects they name).

It creates files in HDF5's earliest format, the one h5py writes unless
asked for a later one: superblock 0, version-1 object headers,
symbol-table groups, 1-D chunked resizable datasets (``TableStore``'s
columns) and N-D contiguous ones (netCDF variables), numeric, string and
object-reference attributes, and dimension scales as HDF5's H5DS
functions lay them out. It writes into every file it reads, of
superblocks 0 to 3, past a user block or not, with the B-tree K values
the superblock or its extension gives. Writing keeps what is on disk
valid until the superblock is rewritten: chunks, contiguous data and
global heap objects go to the end of the file as they come (an unfiltered
chunk's free rows are filled in place), and at ``close`` every object
whose metadata changed gets a new object header (and, for a dataset, a
new chunk B-tree; for a group, a new symbol table) at the end of the
file, its parents up to the root likewise, and last the superblock points
at the new root (superblocks 2 and 3: the end of the file, the root's
address and the checksum; the flags, base and extension addresses kept).
New headers get their addresses before any is written, so that headers
can refer to one another (a dimension scale and the variables it is
attached to); the global heap objects of ``DIMENSION_LIST`` that name a
moved scale are rewritten in place once the new headers are written.
Space left behind is not reused, as HDF5 does not reuse it without a
free-space manager. h5py and the HDF5 library read such a file and can
append to it.

A rewritten object takes the earliest form that keeps its meaning: a
version-1 header, or a version-2 one (with its checksum) where attribute
creation order is tracked or unchanged dense attributes are carried; its
changed attributes in the header; a new-style group as a symbol table,
or as compact link messages with its link and group info where link
creation order is tracked or a link is external; h5py lists both in the
order it listed them. Appending to a version-4 layout carries its chunks,
at their addresses and with their filter masks, to a version-1 B-tree
under a version-3 layout; an appended chunk goes through the dataset's
filters (deflate, shuffle, fletcher32, bzip2, blosc, lzf as literal runs)
and the partly filled last chunk of a filtered dataset is decoded,
filled, encoded and written anew. Committed datatypes are read, never
written.

A file this codec does not read raises ``FormatError``, an ``OSError``,
which names what it found (an unknown filter, a virtual mapping that is
unlimited or names its sources printf-style, mappings of an encoding
other than version 0, a version-4 reference of HDF5 1.12, 2-byte offsets
or lengths); a group of
such datasets is still listed and its attributes read. A write it cannot
make raises before the first byte of it is written, and the file then
commits nothing of that session: a superblock 3 whose writer flags are
set, addresses or lengths of other than 8 bytes, a paged or persisted
file-space manager or a shared-message table in the superblock extension
(each opened to read only), a filter without an encoder here
(scaleoffset, n-bit, szip, an unknown id, blosc's blosclz and snappy), an
append to an external or virtual dataset, an attribute too large for a
header message, a committed datatype. It never hands over to another
reader.
"""

from __future__ import annotations

import os
import struct
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from gpsat_tpu_torch.data.hdf5_selections import RegionReference, Selection, parse_selection
from gpsat_tpu_torch.data.hdf5_structures import (
    FractalHeap,
    btree2_chunks,
    btree2_records,
    check_filters,
    check_sum,
    checksum,
    extensible_array_chunks,
    filter_chunk,
    fixed_array_chunks,
    parse_filters,
    unencodable,
    unfilter,
)
from gpsat_tpu_torch.data.hdf5_types import (
    OBJ_REF_TYPE,
    UNDEF,
    VLEN_REF,
    FormatError,
    Type,
    compound_type_bytes,
    fix_strings,
    parse_space,
    parse_type,
    space_bytes,
    string_type_bytes,
    type_bytes,
    uint,
    vlen_seq_type_bytes,
)

__all__ = ["File", "Group", "Dataset", "Datatype", "Empty", "FormatError", "RegionReference", "guess_chunk_rows"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
GROUP_LEAF_K, GROUP_INTERNAL_K = 4, 16  # HDF5's defaults, in the superblock this codec creates
CHUNK_K = 32  # the chunk B-tree's K: HDF5's default, fixed by a version-0 superblock
GHEAP_MIN = 4096  # the least size of a global heap collection
GHEAP_MAX_OBJECTS = 0xFFFF  # object indices are 16 bits; 0 is the free space
SUPERBLOCK_SIZE = 96  # a version-0 superblock of 8-byte addresses, the one this codec creates
# superblock 3's file-consistency flags (byte 11): a writer, or a SWMR
# writer, has the file open (or did not close it; h5clear clears them)
SB_WRITE_ACCESS, SB_SWMR_WRITE = 0x01, 0x04
MESSAGE_MAX = 0xFFFF  # a header message's body: its size is a 16-bit field
ATTR_MAX_COMPACT, ATTR_MIN_DENSE = 8, 6  # HDF5's attribute phase change defaults (a version-2 header)
LINK_MAX_COMPACT, LINK_MIN_DENSE = 8, 6  # and a new-style group's (the group info message)

# object header message types (IV.A.2)
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK, EXTERNAL, LAYOUT = 0, 1, 2, 3, 4, 5, 6, 7, 8
GROUP_INFO, FILTERS, ATTRIBUTE, CONTINUATION, STAB, ATTR_INFO = 10, 11, 12, 16, 17, 21
SHARED_TABLE, BTREE_K, FSINFO, REFCOUNT = 15, 19, 23, 22

# h5py's chunk guess (h5py/_hl/filters.py): a chunk of CHUNK_BASE scaled by
# the dataset's size, within [CHUNK_MIN, CHUNK_MAX] bytes
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024

# the fill-value message (version 2) HDF5 writes for h5py's datasets: space
# allocated incrementally (chunked) or late (contiguous), the fill written
# if set (numbers) or when allocated (strings), a fill value defined with
# size 0 (the default, zeros)
FILL_NUMBER, FILL_STRING = bytes([2, 3, 2, 1, 0, 0, 0, 0]), bytes([2, 3, 0, 1, 0, 0, 0, 0])
FILL_CONTIGUOUS, FILL_CONTIGUOUS_STRING = bytes([2, 2, 2, 1, 0, 0, 0, 0]), bytes([2, 2, 0, 1, 0, 0, 0, 0])
HEADER_MIN = 256  # HDF5 gives a new object header this much room, a null message in what is free

# the chunk index of a version-4 layout (IV.A.2.i)
CHUNK_INDEXES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array", 5: "version-2 B-tree"}
DIM_SCALE_CLASS = b"DIMENSION_SCALE"

Msg = Tuple[int, int, bytes]  # (type, flags, body)
AttrBody = Union[bytes, Callable[[bool], bytes]]  # a body, or one made when the header is written


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


def guess_chunk_rows(n: int, itemsize: int) -> int:
    """Rows per chunk of a 1-D dataset first written with ``n`` rows: h5py's
    ``guess_chunk``, so that a store has the chunks it would have under h5py."""
    rows = float(n if n else 1024)
    target = CHUNK_BASE * 2 ** np.log10(rows * itemsize / (1024.0 * 1024))
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    while True:
        nbytes = rows * itemsize
        if (nbytes < target or abs(nbytes - target) / target < 0.5) and nbytes < CHUNK_MAX:
            break
        if rows == 1:
            break
        rows = np.ceil(rows / 2.0)
    return int(rows)


class Empty:
    """The value of an attribute or dataset with a null dataspace: no data,
    only a dtype (h5py's ``Empty``)."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


class _Link:
    """A soft or external link: listed by its group, never followed."""

    def __init__(self, kind: str, target: str):
        self.kind, self.target = kind, target


# --------------------------------------------------------------------------
# the file
# --------------------------------------------------------------------------


class File:
    """An HDF5 file. ``mode``: "r" (read only; the file must exist), "r+"
    (read and write; must exist), "a" (read and write; created if missing),
    "w" (created or truncated), "w-" (created; must not exist). The root
    group's ``keys``, ``in``, ``[name]``, ``del``, ``create_group``,
    ``create_dataset`` and ``visit_groups`` are the file's. A write the
    codec refuses raises before it writes anything, and the file then
    commits nothing of this session: ``close`` leaves it as it was
    opened."""

    def __init__(self, path, mode: str = "r"):
        path = os.fspath(path)
        if mode not in ("r", "r+", "a", "w", "w-"):
            raise ValueError(f"invalid mode: {mode!r}")
        if mode == "a":
            mode = "r+" if os.path.exists(path) else "w-"
        self.path, self.mode = path, mode
        self.writable = mode != "r"
        self._gcols: Dict[int, Dict[int, bytes]] = {}  # global heap collections read: addr -> idx -> bytes
        self._gheap = None  # the collection new objects go to: [addr, size, used, next index]
        self._attached: List["Dataset"] = []  # datasets given dimension scales in this session
        self._by_addr: Dict[int, "_Object"] = {}  # objects reached through an object reference
        self._f = None
        self._base = 0  # the superblock's offset in the file: the user block's size; addresses are relative to it
        self._committed: Dict[int, Type] = {}  # committed datatypes read: header address -> type
        self._refusal: Optional[str] = None  # the first write refused in this session
        self._so = self._sl = 8  # the sizes of offsets and lengths (the superblock's; this codec creates 8)
        # the shared-message table's indexes: (message type flags, fractal heap address) each
        self._sohm: List[Tuple[int, int]] = []
        self._sohm_heaps: Dict[int, FractalHeap] = {}
        # the directory of the file as opened: where a virtual dataset's source files are looked for first
        self._dir = os.path.dirname(os.path.abspath(path))
        self._sources: Dict[str, "File"] = {}  # virtual datasets' source files, open until this file closes
        if mode == "w-" and os.path.exists(path):
            raise FileExistsError(f"unable to create file (file exists): {path}")
        if mode in ("w", "w-"):
            self._f = open(path, "w+b")
            self._sb = bytearray(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                                 + struct.pack("<HHI", GROUP_LEAF_K, GROUP_INTERNAL_K, 0) + b"\0" * 72)
            self._sb_pos, self.superblock_version = 24, 0
            self._eoa = SUPERBLOCK_SIZE
            self._write(0, bytes(self._sb))
            self._leaf_k, self._internal_k, self._chunk_k = GROUP_LEAF_K, GROUP_INTERNAL_K, CHUNK_K
            self.root = Group(self, None)
            return
        self._f = open(path, "rb" if mode == "r" else "r+b")
        try:
            self._read_superblock()
        except BaseException:
            self._f.close()
            raise

    # --- raw i/o ---
    def _read(self, addr: int, n: int) -> bytes:
        self._f.seek(self._base + addr)
        out = self._f.read(n)
        if len(out) != n:
            raise FormatError(f"{self.path}: truncated file: {n} bytes at {addr} run past its end")
        return out

    def _read_array(self, addr: int, dtype: np.dtype, count: int) -> np.ndarray:
        """``count`` elements of ``dtype`` at ``addr``, into a new writable array."""
        self._f.seek(self._base + addr)
        out = np.fromfile(self._f, dtype=dtype, count=count)
        if len(out) != count:
            raise FormatError(f"{self.path}: truncated file: {count} elements at {addr} run past its end")
        return out

    def _write(self, addr: int, data) -> None:
        self._f.seek(self._base + addr)
        self._f.write(data)

    def _addr(self, buf: bytes, pos: int) -> int:
        """The address at ``buf[pos:]``, of the file's size of offsets
        (UNDEF where undefined)."""
        return uint(buf, pos, self._so)

    def _length(self, buf: bytes, pos: int) -> int:
        """The length at ``buf[pos:]``, of the file's size of lengths."""
        return uint(buf, pos, self._sl)

    def _alloc(self, n: int) -> int:
        addr = self._eoa
        self._eoa += _pad8(n)
        return addr

    def _append(self, data) -> int:
        """Write ``data`` at the end of the file; its address."""
        addr = self._alloc(len(data))
        self._write(addr, data)
        return addr

    def _refuse(self, msg: str, cls=None) -> OSError:
        """The error of a write refused before it wrote anything (a
        ``FormatError`` unless ``cls`` says otherwise): the file is then not
        flushed, so that no half of a change reaches it."""
        self._refusal = self._refusal or msg
        return (cls or FormatError)(msg)

    # --- superblock (II.A) ---
    def _find_superblock(self) -> int:
        """The superblock's offset: 0, or past a user block, at 512, 1024,
        2048 and so on, as HDF5 searches for it."""
        size, pos = os.fstat(self._f.fileno()).st_size, 0
        while pos < size:
            self._f.seek(pos)
            if self._f.read(8) == SIGNATURE:
                return pos
            pos = 512 if pos == 0 else 2 * pos
        raise FormatError(f"{self.path}: not an HDF5 file (no signature at offset 0, 512, 1024 or any larger "
                          "power of two within the file)")

    def _read_superblock(self) -> None:
        """The superblock (II.A): versions 0 and 1 give the group B-trees' K
        (and version 1 the chunk B-trees'), four addresses and the root
        group's symbol-table entry; versions 2 and 3 four addresses and a
        checksum. Every address and length in the file is as wide as its
        sizes of offsets and lengths say (8 or 4 bytes; HDF5 overflows a
        fractal heap's block sizes at 2); a file of 4 is opened to read
        only."""
        self._base = self._find_superblock()
        self._f.seek(self._base)
        head = self._f.read(16)
        version = self.superblock_version = head[8]
        if version > 3:
            raise FormatError(f"{self.path}: HDF5 superblock version {version} is not one this codec reads "
                              "(it reads versions 0 to 3)")
        so, sl = (head[13], head[14]) if version < 2 else (head[9], head[10])
        if so not in (4, 8) or sl not in (4, 8):
            raise FormatError(f"{self.path}: {so}-byte offsets and {sl}-byte lengths; this codec reads 4- and 8-byte "
                              "ones")
        if self.writable and (so, sl) != (8, 8):
            raise FormatError(f"{self.path}: {so}-byte offsets and {sl}-byte lengths; this codec opens such a file "
                              "to read only (it writes 8-byte ones)")
        self._so, self._sl = so, sl
        # versions 0 and 1: 24 or 28 bytes, four addresses and the root's symbol-table entry (its name's
        # offset, a length; its header's address; the cache type, 4 reserved bytes and the scratch pad); 2
        # and 3: 12 bytes, four addresses and the checksum
        fixed = {0: 24, 1: 28}.get(version, 12)
        size = fixed + 4 * so + (sl + so + 24 if version < 2 else 4)
        self._f.seek(self._base)
        head = self._f.read(size)
        if len(head) < size:
            raise FormatError(f"{self.path}: truncated superblock")
        self._leaf_k, self._internal_k, self._chunk_k = GROUP_LEAF_K, GROUP_INTERNAL_K, CHUNK_K
        addrs = [self._addr(head, fixed + so * i) for i in range(4)]
        self._sb_pos = fixed if version < 2 else fixed + 2 * so  # where flush rewrites the addresses
        if version >= 2:  # the base, the superblock extension, the end of the file, the root group's header
            check_sum(head, self.path, "the superblock")
            (_stored_base, ext, eof, root_addr), access_info = addrs, UNDEF
            if version == 3 and self.writable and head[11] & (SB_WRITE_ACCESS | SB_SWMR_WRITE):
                raise FormatError(f"{self.path}: superblock version 3 with file-consistency flags {head[11]:#04x}: "
                                  "a writer has the file open, or did not close it (h5clear -s clears the "
                                  "flags); this codec opens it to read only")
            if ext != UNDEF:
                self._read_extension(ext)
        else:  # the base, the free-space info (unused), the end of the file, the file-access info
            _stored_base, _free, eof, access_info = addrs
            self._leaf_k, self._internal_k = struct.unpack_from("<HH", head, 16)
            if version == 1:  # the chunk B-trees' K, where H5Pset_istore_k set it
                self._chunk_k = struct.unpack_from("<H", head, 24)[0]
            root_addr = self._addr(head, fixed + 4 * so + sl)
        if access_info != UNDEF:
            raise FormatError(f"{self.path}: a file driver information block; this codec reads files without one")
        self._sb = bytearray(head)
        # HDF5 stores the end of the file as an absolute offset, every other address relative to the superblock
        self._eoa = max(_pad8(eof - self._base), _pad8(os.path.getsize(self.path) - self._base))
        self.root = _load(self, root_addr, "/")
        if not isinstance(self.root, Group):
            raise FormatError(f"{self.path}: the root object is not a group")

    def _read_extension(self, addr: int) -> None:
        """The superblock extension (II.B), an object header: the version-1
        B-trees' K values where they are not HDF5's defaults (message 0x13),
        and the shared-object-header-message table (message 0x0F). A file
        opened to write is refused where the extension holds what this
        codec's writes would leave stale: a shared-object-header-message
        table, or a file-space manager that pages the file or persists its
        free space (HDF5 would hand out space this codec has used)."""
        for mtype, _, body, _ in _read_header(self, addr)[2]:
            if mtype == BTREE_K:
                self._chunk_k, self._internal_k, self._leaf_k = struct.unpack_from("<HHH", body, 1)
            elif mtype == SHARED_TABLE and not self.writable:
                self._read_shared_table(self._addr(body, 1), body[1 + self._so])
            elif not self.writable:
                continue
            elif mtype == SHARED_TABLE:
                raise FormatError(f"{self.path}: a shared-object-header-message table in the superblock "
                                  "extension; this codec opens such a file to read only")
            elif mtype == FSINFO:
                if body[0] == 0:  # version 0 (HDF5 1.10.0): strategy 1 is "all, persisted"
                    paged, persist = False, body[1] == 1
                else:  # version 1: the strategy (1: paged), then whether free space persists
                    paged, persist = body[1] == 1, bool(body[2])
                if paged or persist:
                    what = "paged file-space strategy" if paged else "persisted free-space manager"
                    raise FormatError(f"{self.path}: a {what} (the superblock extension's file-space info); "
                                      "this codec opens such a file to read only")

    # --- lifecycle ---
    def flush(self) -> None:
        """Give every changed object a new header address, write the headers,
        then point the superblock at the new root and the new end of the
        file."""
        if not self.writable:
            return
        if self._refusal:
            raise FormatError(f"{self.path}: this session's changes are not written: {self._refusal}")
        for ds in self._attached:  # a moved dataset moves its scales' REFERENCE_LIST records
            if ds._dirty:
                for scale in {s for scales in ds._dim_scales for s in scales}:
                    scale._dirty = True
        if not self.root._assign():
            return
        rewrites = [w for ds in self._attached for w in ds._place_dimension_list()]
        self.root._write_headers()
        for pos, blob in rewrites:  # after the headers they name, so that what is on disk stays valid
            self._write(pos, blob)
        root, sb, pos = self.root, self._sb, self._sb_pos
        self._f.flush()
        end = self._base + self._eoa
        if os.fstat(self._f.fileno()).st_size < end:
            self._f.truncate(end)  # HDF5 refuses a file shorter than its end-of-file address
        if self.superblock_version >= 2:
            # the end of the file and the root's header; the base and extension addresses and the flags kept
            struct.pack_into("<QQ", sb, pos, end, root._addr)
            struct.pack_into("<I", sb, 44, checksum(bytes(sb[:44])))
        else:
            struct.pack_into("<4Q", sb, pos, self._base, UNDEF, end, UNDEF)
            # the root's symbol-table entry caches its B-tree and heap where it has a symbol table
            cache = (1, root._btree, root._heap) if root._btree != UNDEF else (0, 0, 0)
            struct.pack_into("<QQIIQQ", sb, pos + 32, 0, root._addr, cache[0], 0, cache[1], cache[2])
        self._write(0, bytes(sb))
        self._f.flush()

    def close(self) -> None:
        if self._f is None:
            return
        try:
            if not self._refusal:  # a refused write keeps the file as it was opened
                self.flush()
        finally:
            self._f.close()
            self._f = None
            for src in self._sources.values():
                src.close()
            self._sources.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- the root group's surface ---
    def keys(self) -> List[str]:
        return self.root.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.root

    def __getitem__(self, name: Union[str, RegionReference]):
        return self.root[name]

    def __delitem__(self, name: str):
        del self.root[name]

    def create_group(self, name: str) -> "Group":
        return self.root.create_group(name)

    def create_dataset(self, name: str, data, contiguous: bool = False,
                       chunk_rows: Optional[int] = None) -> "Dataset":
        return self.root.create_dataset(name, data, contiguous=contiguous, chunk_rows=chunk_rows)

    def visit_groups(self) -> Iterator[Tuple[str, "Group"]]:
        return self.root.visit_groups()

    @property
    def attrs(self) -> "Attributes":
        return self.root.attrs

    def _source(self, name: str) -> Optional["File"]:
        """A virtual dataset's source file ``name``, opened to read (once
        while this file is open, as HDF5 caches them), found as HDF5 looks
        by default (``H5F_prefix_open_file`` with no prefix set): an
        absolute name as given, else its last component; then that in this
        file's directory, then from the working directory. None if not
        found."""
        if name == ".":
            return self
        candidates = []
        if os.path.isabs(name):
            candidates.append(name)
            name = os.path.basename(name)
        candidates += [os.path.join(self._dir, name), name]
        path = next((c for c in candidates if os.path.isfile(c)), None)
        if path is None:
            return None
        path = os.path.abspath(path)
        if path not in self._sources:
            self._sources[path] = File(path, "r")
        return self._sources[path]

    # --- object references ---
    def deref(self, addr: int) -> "_Object":
        """The object whose header is at ``addr`` (an object reference), named
        by the first path that reaches it: the root group's links first, then
        its subgroups', breadth first."""
        obj = self._by_addr.get(addr)
        if obj is not None:
            return obj
        queue = [self.root]
        while queue:
            group = queue.pop(0)
            links = group._read_links()
            for name, target in links.items():
                if target == addr:
                    self._by_addr[addr] = obj = group[name]
                    return obj
            for name, target in links.items():
                if isinstance(target, int) and target != UNDEF:
                    child = group[name]
                    if isinstance(child, Group):
                        queue.append(child)
        self._by_addr[addr] = obj = _load(self, addr, None)
        return obj

    # --- shared messages (IV.A.2; the shared-message table, II.B and III.E) ---
    def _read_shared_table(self, addr: int, n: int) -> None:
        """The shared-object-header-message table (``SMTB``): per index, its
        version, type (0 a list, 1 a version-2 B-tree), the message types it
        shares (bit t for message type t), the least size shared, the list
        and B-tree cutoffs, the messages it holds, the index's address and
        its fractal heap's. A shared message names its heap object by heap
        ID, so reading needs each index's heap and message types only; the
        list or B-tree (each record a message's hash and where it is: in the
        heap, or still in the header of its one user, which keeps it as a
        plain message flagged shareable) is not walked."""
        so = self._so
        entry = 14 + 2 * so
        buf = self._read(addr, 4 + n * entry + 4)
        if buf[:4] != b"SMTB":
            raise FormatError(f"{self.path}: no shared-object-header-message table at {addr}")
        check_sum(buf, self.path, f"the shared-object-header-message table at {addr}")
        for i in range(n):
            pos = 4 + i * entry
            if buf[pos] != 0:
                raise FormatError(f"{self.path}: a shared-message index of version {buf[pos]}")
            flags = struct.unpack_from("<H", buf, pos + 2)[0]
            self._sohm.append((flags, self._addr(buf, pos + 14 + so)))

    def _sohm_heap(self, mtype: int, what: str) -> FractalHeap:
        """The fractal heap of the shared-message index of ``mtype`` (an old
        fill-value message's is the fill value's, as ``H5SM__type_to_flag``
        maps it)."""
        bit = FILL if mtype == FILL_OLD else mtype
        for flags, heap_addr in self._sohm:
            if flags >> bit & 1:
                heap = self._sohm_heaps.get(heap_addr)
                if heap is None:
                    heap = self._sohm_heaps[heap_addr] = FractalHeap(self._read, heap_addr, self.path, self._so,
                                                                     self._sl)
                return heap
        raise FormatError(f"{what}: a message of type {mtype} shared in the shared-object-header-message table, "
                          "which has no index of that type")

    def _shared_message(self, mtype: int, body: bytes, what: str) -> bytes:
        """The body of the message of type ``mtype`` that a shared message
        points to: an object in the shared-message table's heap (version 3,
        type 1: an 8-byte heap ID), or a message in another object header
        (versions 1 and 2, version 3 type 2: a committed datatype's)."""
        version, kind = body[0], body[1]
        if version == 3 and kind == 1:
            return self._sohm_heap(mtype, what).get(body[2:10])
        if version not in (1, 2, 3) or (version == 3 and kind != 2):
            raise FormatError(f"{what}: shared message version {version}, type {kind}")
        # version 1: its type, 6 reserved bytes and a length before the address
        addr = self._addr(body, 8 + self._sl if version == 1 else 2)
        found = [b for t, flags, b, _ in _read_header(self, addr)[2] if t == mtype and not flags & 2]
        if not found:
            raise FormatError(f"{what}: no message of type {mtype} in the object header at {addr}")
        return found[0]

    def _shared_type(self, body: bytes, what: str) -> Type:
        """The datatype a shared datatype message points to: a committed
        datatype (its header address kept, for the ``Datatype`` read through
        it) or one in the shared-message table."""
        if body[0] == 3 and body[1] == 1:
            return parse_type(self._shared_message(DATATYPE, body, what))[0]
        addr = self._addr(body, 8 + self._sl if body[0] == 1 else 2)
        t = self._committed.get(addr)
        if t is None:
            t = self._committed[addr] = parse_type(self._shared_message(DATATYPE, body, what))[0]
        return t

    # --- values ---
    def _decode(self, raw: np.ndarray, t: Type) -> np.ndarray:
        """Values as h5py gives them from their bytes on disk (``raw``, of
        ``t.storage``): variable-length elements from the global heap, fixed
        strings as HDF5 converts them, enums of FALSE and TRUE as bool,
        object references as 8-byte addresses, region references as
        ``RegionReference`` values."""
        if t.vlen == "str":
            return self._decode_vlen_str(raw.reshape(-1)).reshape(raw.shape)
        if t.vlen == "seq":
            return self._decode_vlen_seq(raw, t.base)
        if t.region:
            return self._decode_regions(raw)
        if t.cls == 7:  # the address in the first bytes of the size of offsets: H5DS's are 8 wide whatever that is
            addrs = raw.astype(np.uint64)
            if raw.dtype.itemsize > self._so:
                addrs &= np.uint64((1 << 8 * self._so) - 1)
            return addrs
        raw = fix_strings(raw, t)
        if t.dtype.kind == "b" and t.storage.kind != "b":
            return raw.astype(bool)
        if t.cls == 8 and t.dtype.kind != "b":
            return raw.view(t.dtype)  # the enum's members in its metadata, as h5py gives them
        return raw

    # --- global heap (III.E) ---
    def _gheap_objects(self, addr: int) -> Dict[int, bytes]:
        """Every object of the collection at ``addr``: index -> bytes."""
        objs = self._gcols.get(addr)
        if objs is not None:
            return objs
        head = self._read(addr, 8 + self._sl)
        if head[:4] != b"GCOL":
            raise FormatError(f"{self.path}: no global heap collection at {addr}")
        size = self._length(head, 8)
        buf = self._read(addr, size)
        # each object: its index, reference count, 4 reserved bytes and size (padded to 8), its bytes padded to 8
        objs, pos, obj_head = {}, _pad8(8 + self._sl), _pad8(8 + self._sl)
        while pos + obj_head <= size:
            idx = struct.unpack_from("<H", buf, pos)[0]
            n = self._length(buf, pos + 8)
            if idx == 0:  # the free space: the rest of the collection
                break
            objs[idx] = buf[pos + obj_head:pos + obj_head + n]
            pos += obj_head + _pad8(n)
        self._gcols[addr] = objs
        return objs

    def _gheap_object(self, addr: int, idx: int) -> bytes:
        blob = self._gheap_objects(addr).get(idx)
        if blob is None:
            raise FormatError(f"{self.path}: no global heap object {idx} in the collection at {addr}")
        return blob

    def _gheap_put(self, blobs: List[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Store each of ``blobs`` as a global heap object, in this session's
        collections (a new one at the end of the file when the current one is
        full); the (collection address, index) of each, and the file
        position of its bytes."""
        addrs = np.zeros(len(blobs), dtype=np.uint64)
        idxs = np.zeros(len(blobs), dtype=np.uint32)
        at = np.zeros(len(blobs), dtype=np.uint64)
        i = 0
        while i < len(blobs):
            col = self._gheap
            need = 16 + _pad8(len(blobs[i]))
            if col is None or col[2] + need + 16 > col[1] or col[3] > GHEAP_MAX_OBJECTS:
                size = max(GHEAP_MIN, _pad8(16 + need + 16))
                col = self._gheap = [self._alloc(size), size, 16, 1]
                self._write(col[0], struct.pack("<4sB3xQ", b"GCOL", 1, size) + b"\0" * (size - 16))
                self._gcols[col[0]] = {}
            start, parts = col[2], []
            while i < len(blobs) and col[3] <= GHEAP_MAX_OBJECTS:
                blob = blobs[i]
                need = 16 + _pad8(len(blob))
                if col[2] + need + 16 > col[1]:
                    break
                parts.append(struct.pack("<HH4xQ", col[3], 0, len(blob)) + _padded(blob))
                self._gcols[col[0]][col[3]] = blob
                addrs[i], idxs[i], at[i] = col[0], col[3], col[0] + col[2] + 16
                col[2] += need
                col[3] += 1
                i += 1
            # the objects, then the free-space object over the rest
            free = struct.pack("<HH4xQ", 0, 0, col[1] - col[2])
            self._write(col[0] + start, b"".join(parts) + free)
        return addrs, idxs, at

    def _decode_vlen_str(self, refs: np.ndarray) -> np.ndarray:
        """Variable-length string references -> an object array of str."""
        out = np.empty(len(refs), dtype=object)
        if not len(refs):
            return out
        key = (refs["addr"].astype(np.uint64) << np.uint64(16)) | refs["idx"].astype(np.uint64)
        key[refs["len"] == 0] = 0  # an empty string, or the nil reference of an unwritten element
        uniq, first, inverse = np.unique(key, return_index=True, return_inverse=True)
        strs = np.empty(len(uniq), dtype=object)
        for j, (k, n) in enumerate(zip(uniq.tolist(), refs["len"][first].tolist())):
            strs[j] = "" if k == 0 else self._gheap_object(k >> 16, k & 0xFFFF)[:n].decode("utf-8")
        out[:] = strs[inverse.ravel()]
        return out

    def _decode_regions(self, refs: np.ndarray) -> np.ndarray:
        """Region references (a global heap collection's address and an
        object's index, each object the referenced object header's address
        and a serialised selection) -> an object array of
        ``RegionReference``; None where no reference was written."""
        out = np.empty(refs.size, dtype=object)
        for i, (addr, idx) in enumerate(zip(refs["addr"].reshape(-1).tolist(), refs["idx"].reshape(-1).tolist())):
            if addr in (0, UNDEF):
                continue
            blob = self._gheap_object(addr, idx)
            out[i] = RegionReference(self._addr(blob, 0), parse_selection(blob, self._so)[0])
        return out.reshape(refs.shape)

    def _decode_vlen_seq(self, refs: np.ndarray, base: Type) -> np.ndarray:
        """Variable-length sequence references -> an object array of arrays."""
        out = np.empty(refs.size, dtype=object)
        flat = refs.reshape(-1)
        for i, (n, addr, idx) in enumerate(zip(flat["len"].tolist(), flat["addr"].tolist(), flat["idx"].tolist())):
            if n == 0:
                arr = np.zeros(0, dtype=base.storage)
            else:
                arr = np.frombuffer(self._gheap_object(addr, idx), dtype=base.storage, count=n).copy()
            out[i] = self._decode(arr, base)
        return out.reshape(refs.shape)

    def _encode_vlen_str(self, values) -> np.ndarray:
        """An array of str (None stands for "") -> variable-length
        references, each distinct string stored once (HDF5 stores each
        element; a reader cannot tell the two apart)."""
        lookup: Dict[str, int] = {}
        inverse = np.fromiter(
            (lookup.setdefault(v if type(v) is str else ("" if v is None else str(v)), len(lookup)) for v in values),
            dtype=np.int64, count=len(values))
        blobs = [u.encode("utf-8") for u in lookup]
        addrs, idxs, _ = self._gheap_put(blobs)  # "" too: HDF5 stores it as an object of 0 bytes
        refs = np.zeros(len(inverse), dtype=VLEN_REF)
        refs["len"] = np.array([len(b) for b in blobs], dtype=np.uint32)[inverse]
        refs["addr"], refs["idx"] = addrs[inverse], idxs[inverse]
        return refs


# --------------------------------------------------------------------------
# object headers (IV.A.1)
# --------------------------------------------------------------------------


def _read_header(file: File, addr: int) -> Tuple[int, int, List[Tuple[int, int, bytes, int]]]:
    """The object header at ``addr``: its version, its flags (version 2; 0
    for version 1) and its messages as (type, flags, body, creation order),
    continuation blocks followed, null messages and continuations left out."""
    head = file._read(addr, 16)
    if head[:4] == b"OHDR":
        return _read_header_v2(file, addr)
    version, _, nmsgs, _refs, size = struct.unpack_from("<BBHII", head, 0)
    if version != 1:
        raise FormatError(f"{file.path}: object header version {version} at {addr}")
    blocks, msgs = [(addr + 16, size)], []
    while blocks:
        start, size = blocks.pop(0)
        buf = file._read(start, size)
        pos = 0
        while pos + 8 <= size:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
            body = buf[pos + 8:pos + 8 + msize]
            pos += 8 + msize
            if mtype == CONTINUATION:
                blocks.append((file._addr(body, 0), file._length(body, file._so)))
            elif mtype != NIL:
                msgs.append((mtype, flags, body, 0))
    return 1, 0, msgs


def _read_header_v2(file: File, addr: int):
    """A version-2 object header (IV.A.1.b): ``OHDR``, its flags (bits 0-1
    the width of chunk 0's size, 2 attribute creation order tracked, 4
    attribute phase change values stored, 5 times stored), chunk 0, and
    ``OCHK`` continuation blocks, each with its checksum."""
    head = file._read(addr, 6)
    if head[4] != 2:
        raise FormatError(f"{file.path}: object header version {head[4]} at {addr}")
    flags = head[5]
    prefix = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    chunk0 = int.from_bytes(file._read(addr + prefix, width), "little")
    prefix += width
    buf = file._read(addr, prefix + chunk0 + 4)
    check_sum(buf, file.path, f"the object header at {addr}")
    hsize = 6 if flags & 0x04 else 4
    blocks, msgs = [(buf, prefix, prefix + chunk0)], []
    while blocks:
        buf, pos, end = blocks.pop(0)
        while pos + hsize <= end:
            mtype, msize, mflags = struct.unpack_from("<BHB", buf, pos)
            corder = struct.unpack_from("<H", buf, pos + 4)[0] if flags & 0x04 else 0
            body = buf[pos + hsize:pos + hsize + msize]
            pos += hsize + msize
            if mtype == CONTINUATION:
                caddr, clen = file._addr(body, 0), file._length(body, file._so)
                cbuf = file._read(caddr, clen)
                if cbuf[:4] != b"OCHK":
                    raise FormatError(f"{file.path}: no object header continuation block at {caddr}")
                check_sum(cbuf, file.path, f"the object header continuation block at {caddr}")
                blocks.append((cbuf, 4, clen - 4))
            elif mtype != NIL:
                msgs.append((mtype, mflags, body, corder))
    return 2, flags, msgs


def _header_bytes(msgs: List[Msg], refcount: int = 1) -> bytes:
    """A version-1 object header holding ``msgs`` in one block, a null
    message after them up to HEADER_MIN bytes, as HDF5 leaves room to add
    messages in place."""
    parts = []
    for mtype, flags, body in msgs:
        body = _padded(body)
        parts.append(struct.pack("<HHB3x", mtype, len(body), flags) + body)
    data = b"".join(parts)
    if len(data) + 8 <= HEADER_MIN:
        data += struct.pack("<HHB3x", NIL, HEADER_MIN - len(data) - 8, 0) + b"\0" * (HEADER_MIN - len(data) - 8)
        parts.append(None)
    return struct.pack("<BBHII4x", 1, 0, len(parts), refcount, len(data)) + data


def _header_v2_bytes(msgs: List[Tuple[int, int, bytes, int]], flags: int,
                     phase: Optional[Tuple[int, int]] = None) -> bytes:
    """A version-2 object header (IV.A.1.b) holding ``msgs`` (type, flags,
    body, creation order) in chunk 0, a null message after them up to
    HEADER_MIN bytes, and its checksum. ``flags`` keeps bits 2 and 3
    (attribute creation order tracked, indexed); ``phase`` (the most compact
    attributes, the least dense ones) is stored where given. No times."""
    tracked = bool(flags & 0x04)
    hsize = 6 if tracked else 4
    corder = (lambda c: struct.pack("<H", c)) if tracked else (lambda c: b"")
    data = b"".join(struct.pack("<BHB", mtype, len(body), mflags) + corder(c) + body
                    for mtype, mflags, body, c in msgs)
    if len(data) + hsize <= HEADER_MIN:
        pad = HEADER_MIN - len(data) - hsize
        data += struct.pack("<BHB", NIL, pad, 0) + corder(0) + b"\0" * pad
    width = next(w for w in range(3) if len(data) < 1 << (8 << w)) if len(data) < 1 << 32 else 3
    flags = (flags & 0x0C) | width | (0x10 if phase else 0)
    blob = (b"OHDR" + bytes([2, flags]) + (struct.pack("<HH", *phase) if phase else b"")
            + len(data).to_bytes(1 << width, "little") + data)
    return blob + struct.pack("<I", checksum(blob))


def _load(file: File, addr: int, name: Optional[str]):
    _, hflags, msgs = _read_header(file, addr)
    types = {m[0] for m in msgs}
    if STAB in types or LINK_INFO in types or LINK in types:
        cls = Group
    elif LAYOUT in types:
        cls = Dataset
    elif DATATYPE in types:
        cls = Datatype
    else:
        cls = _Object
    obj = cls(file, addr, msgs, hflags=hflags)
    obj.name = name
    return obj


# --------------------------------------------------------------------------
# attributes (IV.A.2.m, IV.A.2.v)
# --------------------------------------------------------------------------


class Attributes:
    """An object's attributes: ``attrs[name]`` (a str for a variable-length
    string, a numpy value otherwise), ``get``, ``attrs[name] = value`` (a
    str, a number or a numeric array), ``in``, ``keys``, ``items``."""

    def __init__(self, obj: "_Object"):
        self._obj = obj

    def keys(self) -> List[str]:
        return list(self._obj._attrs)

    def __contains__(self, name: str) -> bool:
        return name in self._obj._attrs

    def __getitem__(self, name: str):
        return self._obj._attr_value(name)

    def get(self, name: str, default=None):
        return self[name] if name in self else default

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __setitem__(self, name: str, value) -> None:
        self._obj._set_attr(name, value)


def _attr_name(body: bytes) -> str:
    version = body[0]
    name_size = struct.unpack_from("<H", body, 2)[0]
    pos = 9 if version == 3 else 8
    return body[pos:pos + name_size].split(b"\0", 1)[0].decode("utf-8")


def _parse_attr(file: File, body: bytes, what: str):
    """(datatype, dims, offset of the data) of an attribute message of
    version 1, 2 or 3; dims None for a null dataspace. A shared datatype or
    dataspace (flags bits 0 and 1) is read where it is shared: a committed
    datatype's header, or the shared-message table."""
    version = body[0]
    name_size, type_size, space_size = struct.unpack_from("<HHH", body, 2)
    if version == 1:
        pos = 8 + _pad8(name_size)
        t, _ = parse_type(body, pos)
        pos += _pad8(type_size)
        dims, _ = parse_space(body[pos:pos + space_size], file._sl)
        return t, dims, pos + _pad8(space_size)
    if version in (2, 3):
        pos = 8 + (1 if version == 3 else 0) + name_size
        t = file._shared_type(body[pos:pos + type_size], what) if body[1] & 1 else parse_type(body, pos)[0]
        pos += type_size
        space = body[pos:pos + space_size]
        if body[1] & 2:
            space = file._shared_message(DATASPACE, space, what)
        dims, _ = parse_space(space, file._sl)
        return t, dims, pos + space_size
    raise FormatError(f"{what}: attribute message version {version}")


def _simple_space(dims: Tuple[int, ...]) -> bytes:
    """The dataspace h5py writes for data of ``dims``: a scalar for rank 0,
    else the dims with a maximum equal to them."""
    return space_bytes(tuple(dims), tuple(dims) if dims else None)


def _attr_bytes(name: str, tb: bytes, sb: bytes, data: bytes) -> bytes:
    """A version-1 attribute message."""
    name_b = name.encode("utf-8") + b"\0"
    return (struct.pack("<BBHHH", 1, 0, len(name_b), len(tb), len(sb))
            + _padded(name_b) + _padded(tb) + _padded(sb) + data)


class _Object:
    """What a group and a dataset share: the header's address, the messages
    kept as they were read, the attributes (raw message bodies, decoded on
    demand; in creation order where the header tracks it, else by name, as
    h5py lists them), whether the header must be written anew, and why it
    may not be (``_frozen``: a committed datatype, which this codec reads
    and never writes).

    A changed object gets a new header in the earliest form that keeps its
    meaning: version 1, unless its attributes' creation order is tracked (a
    flag of the version-2 header, each attribute's order in its message)
    or its dense attributes are carried unchanged (HDF5 looks for dense
    storage from a version-2 header only); then version 2. Attributes that
    changed are all written into the header, the attribute info message
    then pointing at no heap; unchanged dense ones keep their fractal heap
    and B-trees, which this codec never writes inside."""

    def __init__(self, file: File, addr: Optional[int], msgs=(), hflags: int = 0):
        self._file = file
        self._addr = addr
        self._parent: Optional["Group"] = None
        self.name: Optional[str] = "/" if addr is None else None
        self._frozen: Optional[str] = None
        self._attrs: Dict[str, AttrBody] = {}
        self._attr_corder: Dict[str, int] = {}  # each attribute's creation order, where it is tracked
        self._msgs: List[Msg] = []
        self._hflags = hflags & 0x0C  # attribute creation order tracked (bit 2) and indexed (bit 3)
        self._ainfo: Optional[Tuple[int, bytes]] = None  # the attribute info message (flags, body) as read
        self._attr_dense = False  # attributes in a fractal heap, not in the header
        self._phase: Optional[Tuple[int, int]] = None  # a version-2 header's attribute phase change values
        self._refcount = 1  # a version-2 header's reference count message, where it has one
        found = []
        for mtype, flags, body, corder in msgs:
            if mtype == ATTRIBUTE:
                if flags & 2:  # in the shared-message table (the file is then read only)
                    body = file._shared_message(ATTRIBUTE, body, f"{file.path}: an attribute at {addr}")
                found.append((corder, _attr_name(body), body))
            elif mtype == ATTR_INFO:
                self._ainfo = (flags, body)
                self._hflags |= (body[1] & 3) << 2
                found.extend(self._dense_attrs(body))
            elif mtype == REFCOUNT:
                self._refcount = struct.unpack_from("<I", body, 1)[0]
            else:
                self._msgs.append((mtype, flags, body))
        if hflags & 0x10:  # the phase change values follow the flags, and the times where they are stored
            self._phase = struct.unpack("<HH", file._read(addr + 6 + (16 if hflags & 0x20 else 0), 4))
        tracked = self._attr_tracked
        found.sort(key=(lambda a: a[0]) if tracked else (lambda a: a[1].encode("utf-8")))
        self._attrs = {name: body for _, name, body in found}
        if tracked:
            self._attr_corder = {name: corder for corder, name, _ in found}
        stored = struct.unpack_from("<H", self._ainfo[1], 2)[0] if tracked and self._ainfo else 0
        self._attr_next = max([stored, *(c + 1 for c in self._attr_corder.values())])
        self._attrs_dirty = False  # an attribute added or replaced since the header was read
        self._dirty = addr is None
        self._pending = False

    @property
    def _attr_tracked(self) -> bool:
        return bool(self._hflags & 0x04)

    def _dense_attrs(self, info: bytes):
        """The attributes of an attribute-info message (IV.A.2.v) kept in a
        fractal heap under a version-2 B-tree of type 8: (creation order,
        name, body) each."""
        f = self._file
        pos = 2 + (2 if info[1] & 1 else 0)
        heap_addr, name_btree = f._addr(info, pos), f._addr(info, pos + f._so)
        if heap_addr == UNDEF:
            return []
        self._attr_dense = True
        heap = FractalHeap(f._read, heap_addr, f.path, f._so, f._sl)
        btype, recs = btree2_records(f._read, name_btree, f.path, f._so, f._sl)
        if btype != 8:
            raise FormatError(f"{f.path}: an attribute name index of B-tree type {btype} at {name_btree}")
        out = []
        for r in recs:
            mflags, corder = struct.unpack_from("<BI", r, 8)
            # a shared attribute's heap ID is the shared-message table's heap's
            where = f._sohm_heap(ATTRIBUTE, f"{f.path}: an attribute at {self._addr}") if mflags & 2 else heap
            body = where.get(r[:8])
            out.append((corder, _attr_name(body), body))
        return out

    @property
    def attrs(self) -> Attributes:
        return Attributes(self)

    def _attr_value(self, name: str):
        body = self._attrs[name]
        if callable(body):
            body = body(False)
        what = f"{self._file.path}: attribute {name!r}"
        t, dims, pos = _parse_attr(self._file, body, what)
        t.check(what)
        if dims is None:
            return Empty(t.dtype)
        n = int(np.prod(dims)) if dims else 1
        raw = np.frombuffer(body, dtype=t.storage, count=n, offset=pos).copy()
        vals = self._file._decode(raw, t)
        if not dims:
            return vals[0]
        return vals.reshape(dims)

    def _check_writable(self):
        """Refuse, before anything is written, a change this object's header
        or an ancestor's could not take."""
        f = self._file
        if not f.writable:
            raise OSError(f"{f.path}: file is read-only")
        if self._frozen:
            raise f._refuse(f"{f.path}: the object at {self._addr} is {self._frozen}; this codec reads it "
                            "and does not write it")
        obj = self
        while obj is not None:
            obj._check_rewritable()
            obj = obj._parent

    def _check_rewritable(self) -> None:
        """Raise where this object's header could not be written anew."""

    def _check_attrs_fit(self, extra: int = 0) -> None:
        """Every attribute goes into the header once one changes: each must
        fit in a header message (``extra``: the size of the one to add)."""
        sizes = [len(b) for b in self._attrs.values() if not callable(b)] + [extra]
        if max(sizes) > MESSAGE_MAX:
            raise self._file._refuse(f"{self._file.path}: an attribute of {max(sizes)} bytes at {self._addr}, "
                                     f"over the {MESSAGE_MAX} a header message holds; this codec writes "
                                     "attributes into the object header")

    def _set_attr(self, name: str, value) -> None:
        self._check_writable()
        if isinstance(value, str):
            self._check_attrs_fit()
            ref = self._file._encode_vlen_str([value])
            body = _attr_bytes(name, type_bytes(object), space_bytes(()), ref.tobytes())
        else:
            arr = np.asarray(value)
            if arr.dtype.kind not in "biuf":
                raise TypeError(f"attribute {name!r}: this codec writes str and numeric attributes, got "
                                f"{type(value).__name__}")
            if isinstance(value, (int, float, bool)) and not isinstance(value, np.generic):
                arr = np.asarray(value, dtype={int: np.int64, float: np.float64, bool: np.bool_}[type(value)])
            arr = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<") if arr.dtype.itemsize > 1 else None)
            body = _attr_bytes(name, type_bytes(arr.dtype), _simple_space(arr.shape), arr.tobytes())
            self._check_attrs_fit(len(body))
        self._put_attr(name, body)

    def _set_attr_raw(self, name: str, body: AttrBody) -> None:
        self._check_writable()
        self._check_attrs_fit()
        self._put_attr(name, body)

    def _put_attr(self, name: str, body: AttrBody) -> None:
        """Add or replace an attribute. Where creation order is tracked a
        replaced one moves to the end, as h5py (which deletes it and
        creates it anew) leaves it; else the attributes stay in name order."""
        if self._attr_tracked:
            self._attrs.pop(name, None)
            self._attrs[name] = body
            self._attr_corder[name] = self._attr_next
            self._attr_next += 1
        else:
            self._attrs[name] = body
            self._attrs = dict(sorted(self._attrs.items(), key=lambda kv: kv[0].encode("utf-8")))
        self._attrs_dirty = self._dirty = True

    def _header_msgs(self, final: bool) -> List[Tuple[int, int, bytes, int]]:
        """The header's messages (type, flags, body, creation order)."""
        msgs = [(m, fl, b, 0) for m, fl, b in self._msgs]
        if self._attr_dense and not self._attrs_dirty:  # carried: the heap and B-trees as they are
            return msgs + [(ATTR_INFO, *self._ainfo, 0)]
        if self._attr_tracked:  # the attributes in the header, the info message kept for their order
            info_flags = self._ainfo[0] if self._ainfo else 0
            bits = self._hflags >> 2 & 3
            body = (bytes([0, bits]) + struct.pack("<HQQ", self._attr_next, UNDEF, UNDEF)
                    + (struct.pack("<Q", UNDEF) if bits & 2 else b""))
            msgs.append((ATTR_INFO, info_flags, body, 0))
        return msgs + [(ATTRIBUTE, 0, b(final) if callable(b) else b, self._attr_corder.get(name, 0))
                       for name, b in self._attrs.items()]

    def _header(self, final: bool) -> bytes:
        msgs = self._header_msgs(final)
        if not (self._attr_tracked or (self._attr_dense and not self._attrs_dirty)):
            return _header_bytes([m[:3] for m in msgs], self._refcount)
        if self._refcount > 1:
            msgs.append((REFCOUNT, 0, bytes([0]) + struct.pack("<I", self._refcount), 0))
        phase = self._phase
        compact = sum(m[0] == ATTRIBUTE for m in msgs)
        most, least = phase or (ATTR_MAX_COMPACT, ATTR_MIN_DENSE)
        if compact > most:  # raised, so that HDF5 keeps them compact
            phase = (compact, min(least, compact))
        return _header_v2_bytes(msgs, self._hflags, phase)

    def _assign(self) -> bool:
        """Reserve a new header at the end of the file if this object changed;
        True when it did (its parent must point at the new address)."""
        if not self._dirty:
            return False
        self._addr = self._file._alloc(len(self._header(False)))
        self._dirty, self._pending = False, True
        return True

    def _write_headers(self) -> None:
        if self._pending:
            self._file._write(self._addr, self._header(True))
            self._pending = False
            if self._attrs_dirty:  # the attributes now live in the header
                self._attr_dense = False


class Datatype(_Object):
    """A committed datatype (h5py's ``Datatype``): its ``dtype`` and its
    attributes."""

    def __init__(self, file: File, addr: Optional[int], msgs=(), hflags: int = 0):
        super().__init__(file, addr, msgs, hflags)
        body = next(b for mtype, _, b in self._msgs if mtype == DATATYPE)
        self._type = file._committed.setdefault(addr, parse_type(body)[0])
        self._frozen = "a committed datatype"

    @property
    def dtype(self) -> np.dtype:
        return self._type.dtype


# --------------------------------------------------------------------------
# groups (IV.A.2.c, IV.A.2.f, IV.A.2.g, IV.A.2.r; III.A.1, III.C, III.D)
# --------------------------------------------------------------------------


def _parse_link(body: bytes, so: int = 8):
    """A link message: (name, target, creation order); the target is an
    object header address (``so`` bytes) for a hard link, a ``_Link``
    otherwise."""
    flags, pos = body[1], 2
    ltype = 0
    if flags & 0x08:
        ltype, pos = body[pos], pos + 1
    corder = 0
    if flags & 0x04:
        corder, pos = struct.unpack_from("<q", body, pos)[0], pos + 8
    if flags & 0x10:
        pos += 1  # the name's character set
    width = 1 << (flags & 3)
    n = int.from_bytes(body[pos:pos + width], "little")
    pos += width
    name = body[pos:pos + n].decode("utf-8")
    pos += n
    if ltype == 0:
        return name, uint(body, pos, so), corder
    size = struct.unpack_from("<H", body, pos)[0]
    info = body[pos + 2:pos + 2 + size]
    if ltype == 1:
        return name, _Link("soft", info.decode("utf-8")), corder
    if ltype == 64:
        parts = info[1:].split(b"\0")
        return name, _Link("external", f"{parts[0].decode('utf-8')}:{parts[1].decode('utf-8')}"), corder
    return name, _Link(f"user-defined (type {ltype})", info.hex()), corder


def _link_bytes(name: str, addr: int, corder: Optional[int]) -> bytes:
    """A hard link message (version 1): the creation order where it is
    tracked, the UTF-8 character set where the name is not ASCII."""
    nb = name.encode("utf-8")
    width = 0 if len(nb) < 1 << 8 else 1 if len(nb) < 1 << 16 else 2
    utf8 = not name.isascii()
    flags = width | (0x04 if corder is not None else 0) | (0x10 if utf8 else 0)
    return (bytes([1, flags]) + (struct.pack("<q", corder) if corder is not None else b"")
            + (b"\x01" if utf8 else b"") + len(nb).to_bytes(1 << width, "little") + nb + struct.pack("<Q", addr))


class Group(_Object):
    """A group: its links (name -> object header address, read when first
    asked for) and the objects loaded through it. Symbol-table groups and
    new-style groups (link messages, dense links) are read and written.

    A group whose links change is written as a symbol table (III.C), the
    earliest form, unless it tracks its links' creation order or holds a
    link a symbol table cannot (an external link): then its links go into
    the header as link messages, with the link info message (no heap: the
    links are compact) and the group info message, its most compact links
    raised to their number. A group whose links did not change keeps its
    link messages as they were read."""

    def __init__(self, file: File, addr: Optional[int], msgs=(), hflags: int = 0):
        super().__init__(file, addr, msgs, hflags)
        self._btree = self._heap = UNDEF
        self._link_info: Optional[Tuple[int, bytes]] = None
        self._group_info: Optional[Tuple[int, bytes]] = None
        self._link_msgs: List[bytes] = []
        # a new-style group's link messages as read (link info, group info,
        # links), written back while the links are unchanged; None once rebuilt
        self._link_orig: Optional[List[Tuple[int, int, bytes, int]]] = []
        rest = []
        for mtype, flags, body in self._msgs:
            if mtype == STAB:
                self._btree, self._heap = file._addr(body, 0), file._addr(body, file._so)
            elif mtype in (LINK_INFO, GROUP_INFO, LINK):
                self._link_orig.append((mtype, flags, body, 0))
                if mtype == LINK_INFO:
                    self._link_info = (flags, body)
                elif mtype == GROUP_INFO:
                    self._group_info = (flags, body)
                else:
                    self._link_msgs.append(body)
            else:
                rest.append((mtype, flags, body))
        self._msgs = rest
        self._stab = addr is None or self._btree != UNDEF
        info = self._link_info[1] if self._link_info else b"\0\0"
        self._link_track = bool(info[1] & 1)
        self._link_next = struct.unpack_from("<q", info, 2)[0] if self._link_track else 0
        self._link_corder: Dict[str, int] = {}  # each link's creation order, where it is tracked
        self._link_raw: Dict[str, bytes] = {}  # a soft or external link's message, as read
        self._links: Optional[Dict[str, Union[int, _Link]]] = None if addr is not None else {}
        self._cache: Dict[str, bytes] = {}  # a symbol-table entry's cache type and scratch pad, as read
        self._objs: Dict[str, _Object] = {}
        self._links_dirty = addr is None

    # --- reading the links ---
    def _read_links(self) -> Dict[str, Union[int, _Link]]:
        if self._links is not None:
            return self._links
        f = self._file
        if self._btree != UNDEF:
            heap = _local_heap(f, self._heap)
            links: Dict[str, int] = {}
            self._walk_btree(self._btree, heap, links)
            self._links = dict(sorted(links.items(), key=lambda kv: kv[0].encode("utf-8")))
            return self._links
        bodies = list(self._link_msgs)
        if self._link_info is not None:
            info = self._link_info[1]
            pos = 2 + (8 if self._link_track else 0)
            heap_addr, name_btree = f._addr(info, pos), f._addr(info, pos + f._so)
            if heap_addr != UNDEF:  # dense: link messages in a fractal heap, a B-tree of type 5 over their names
                heap = FractalHeap(f._read, heap_addr, f.path, f._so, f._sl)
                btype, recs = btree2_records(f._read, name_btree, f.path, f._so, f._sl)
                if btype != 5:
                    raise FormatError(f"{f.path}: a link name index of B-tree type {btype} at {name_btree}")
                bodies.extend(heap.get(r[4:]) for r in recs)
        found = []
        for body in bodies:
            name, target, corder = _parse_link(body, f._so)
            found.append((name, target, corder))
            if isinstance(target, _Link):
                self._link_raw[name] = body
        found.sort(key=(lambda x: x[2]) if self._link_track else (lambda x: x[0].encode("utf-8")))
        self._links = {name: target for name, target, _ in found}
        if self._link_track:
            self._link_corder = {name: corder for name, _, corder in found}
            self._link_next = max([self._link_next, *(c + 1 for c in self._link_corder.values())])
        return self._links

    def _walk_btree(self, addr: int, heap: bytes, links: Dict[str, int]) -> None:
        """A group B-tree node (signature, type 0, level, entries, siblings;
        then keys, heap offsets of lengths' size, between child addresses)
        and, at level 0, its symbol-table nodes: entries of a name's heap
        offset (a length), the header's address, the cache type, 4 reserved
        bytes and the scratch pad."""
        f = self._file
        so, sl = f._so, f._sl
        head = f._read(addr, 8 + 2 * so)
        if head[:4] != b"TREE" or head[4] != 0:
            raise FormatError(f"{f.path}: no group B-tree node at {addr}")
        level, n = head[5], struct.unpack_from("<H", head, 6)[0]
        body = f._read(addr + 8 + 2 * so, (sl + so) * n + sl)
        children = [f._addr(body, sl + (sl + so) * i) for i in range(n)]
        esize = sl + so + 24
        for child in children:
            if level:
                self._walk_btree(child, heap, links)
                continue
            node = f._read(child, 8)
            if node[:4] != b"SNOD":
                raise FormatError(f"{f.path}: no symbol-table node at {child}")
            count = struct.unpack_from("<H", node, 6)[0]
            entries = f._read(child + 8, esize * count)
            for j in range(count):
                e = esize * j
                name_off, header = f._length(entries, e), f._addr(entries, e + sl)
                cache_type, value_off = struct.unpack_from("<I4xI", entries, e + sl + so)
                name = heap[name_off:heap.index(b"\0", name_off)].decode("utf-8")
                if cache_type == 2:  # a soft link: its value in the local heap
                    links[name] = _Link("soft", heap[value_off:heap.index(b"\0", value_off)].decode("utf-8"))
                else:
                    links[name] = header
                    self._cache[name] = entries[e + sl + so:e + esize]

    # --- the surface ---
    def keys(self) -> List[str]:
        return list(self._read_links())

    def __contains__(self, name: str) -> bool:
        head, _, rest = name.strip("/").partition("/")
        if head not in self._read_links():
            return False
        if not rest:
            return True
        obj = self[head]
        return isinstance(obj, Group) and rest in obj

    def __getitem__(self, name: Union[str, RegionReference]):
        if isinstance(name, RegionReference):  # the object it names, as h5py's group[ref]
            return self._file.deref(name.addr)
        head, _, rest = name.strip("/").partition("/")
        links = self._read_links()
        if head not in links:
            raise KeyError(f"{name!r} not in {self._file.path}")
        obj = self._objs.get(head)
        if obj is None:
            target = links[head]
            if isinstance(target, _Link):
                raise FormatError(f"{self._file.path}: {head!r} is a {target.kind} link to {target.target}; this "
                                  "codec lists soft and external links and does not follow them")
            obj = self._objs[head] = _load(self._file, target, f"{(self.name or '').rstrip('/')}/{head}")
            obj._parent = self
        return obj[rest] if rest else obj

    def __delitem__(self, name: str) -> None:
        self._check_writable()
        links = self._read_links()
        if name not in links:
            raise KeyError(f"{name!r} not in {self._file.path}")
        del links[name]
        for held in (self._objs, self._cache, self._link_corder, self._link_raw):
            held.pop(name, None)
        self._links_dirty = True

    def create_group(self, name: str) -> "Group":
        self._new_name(name)
        return self._add(name, Group(self._file, None))

    def create_dataset(self, name: str, data, contiguous: bool = False,
                       chunk_rows: Optional[int] = None) -> "Dataset":
        """A dataset holding ``data`` (a numpy array of a numeric or bool
        dtype, or of str for variable-length UTF-8 strings): by default a
        chunked, resizable 1-D dataset, its chunks of ``chunk_rows`` rows or,
        without it, as h5py would choose them for ``data``; with
        ``contiguous`` one of any rank (0 a scalar), its data written now in
        one block, as h5py writes ``create_dataset(name, data=data)``."""
        self._new_name(name)
        data = np.asarray(data)
        vlen = data.dtype == object or data.dtype.kind in ("U", "S")
        dtype = np.dtype(object) if vlen else data.dtype.newbyteorder("<") if data.dtype.itemsize > 1 else data.dtype
        ds = Dataset(self._file, None)
        ds._type, _ = parse_type(type_bytes(dtype))
        if contiguous:
            f = self._file
            raw = f._encode_vlen_str(data.reshape(-1)) if vlen else np.ascontiguousarray(data, dtype=dtype)
            nbytes = raw.nbytes
            addr = f._append(raw.tobytes()) if nbytes else UNDEF
            ds._shape, ds._maxshape, ds._kind, ds._chunk = tuple(data.shape), None, "contiguous", None
            ds._msgs = [(DATASPACE, 0, _simple_space(ds._shape)), (DATATYPE, 1, ds._type.raw),
                        (FILL, 1, FILL_CONTIGUOUS_STRING if vlen else FILL_CONTIGUOUS),
                        (LAYOUT, 0, struct.pack("<BBQQ", 3, 1, addr, nbytes))]
            ds._data_addr = addr
            return self._add(name, ds)
        if data.ndim != 1:
            raise ValueError(f"{name!r}: this codec writes chunked 1-D datasets, got shape {data.shape}")
        ds._shape, ds._maxshape, ds._kind = (0,), (UNDEF,), "chunked"
        if chunk_rows is not None and chunk_rows < 1:
            raise ValueError(f"{name!r}: chunk_rows must be at least 1, got {chunk_rows}")
        ds._chunk = (chunk_rows or guess_chunk_rows(len(data), 8 if vlen else dtype.itemsize),)
        ds._msgs = [(DATASPACE, 0, b""), (DATATYPE, 1, ds._type.raw), (FILL, 1, FILL_STRING if vlen else FILL_NUMBER),
                    (LAYOUT, 0, b"")]
        ds._chunks = (np.zeros((0, 1), np.uint64), np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                      np.zeros(0, np.uint32))
        self._add(name, ds)
        ds.append(data)
        return ds

    def visit_groups(self, prefix: str = "") -> Iterator[Tuple[str, "Group"]]:
        """(path, group) for every group below this one, depth first, through
        hard links."""
        for name, target in list(self._read_links().items()):
            if isinstance(target, _Link):
                continue
            obj = self[name]
            if isinstance(obj, Group):
                path = f"{prefix}{name}"
                yield path, obj
                yield from obj.visit_groups(path + "/")

    def _new_name(self, name: str) -> None:
        self._check_writable()
        if not name or "/" in name or "." == name:
            raise ValueError(f"invalid object name: {name!r}")
        if name in self._read_links():
            raise ValueError(f"unable to create {name!r}: name already exists")

    def _add(self, name: str, obj: _Object) -> _Object:
        self._read_links()[name] = UNDEF
        if self._link_track:  # the next creation order, the link listed last
            self._link_corder[name] = self._link_next
            self._link_next += 1
        else:
            self._links = dict(sorted(self._links.items(), key=lambda kv: kv[0].encode("utf-8")))
        self._objs[name] = obj
        obj._parent = self
        obj.name = f"{(self.name or '').rstrip('/')}/{name}"
        self._links_dirty = True
        return obj

    # --- writing ---
    def _check_rewritable(self) -> None:
        if not self._stab and len(self._read_links()) >= MESSAGE_MAX and not self._stab_holds():
            raise self._file._refuse(f"{self._file.path}: the group at {self._addr} holds {len(self._links)} links "
                                     "that a symbol table cannot hold; this codec keeps them in its header, fewer "
                                     f"than {MESSAGE_MAX}")

    def _stab_holds(self) -> bool:
        """Whether a symbol table keeps what this group's links mean: hard
        and soft links, no creation order."""
        return not self._link_track and all(
            not isinstance(t, _Link) or t.kind == "soft" for t in self._read_links().values())

    def _assign(self) -> bool:
        """Reserve new headers for what changed below this group, then write
        its symbol table (or rebuild its link messages) and reserve its own
        header if they changed."""
        for name, obj in self._objs.items():
            if obj._assign():
                self._links[name] = obj._addr
                self._links_dirty = True
        if self._links_dirty:
            self._link_orig = None
            if self._stab or self._stab_holds():
                self._stab = True
                self._write_symbol_table()
            self._links_dirty = False
            self._dirty = True
        return super()._assign()

    def _write_headers(self) -> None:
        for obj in self._objs.values():
            obj._write_headers()
        super()._write_headers()

    def _header_msgs(self, final: bool):
        if self._stab:
            links = [(STAB, 0, struct.pack("<QQ", self._btree, self._heap), 0)]
        elif self._link_orig is not None:
            links = self._link_orig
        else:
            links = self._compact_links()
        return links + super()._header_msgs(final)

    def _compact_links(self) -> List[Tuple[int, int, bytes, int]]:
        """Link info (no fractal heap, no B-trees), group info (its most
        compact links raised to their number where they outnumber it) and
        one link message per link."""
        links = self._read_links()
        info_flags, info = self._link_info or (0, b"\0\0")
        bits = info[1] & 3
        body = (bytes([0, bits]) + (struct.pack("<q", self._link_next) if bits & 1 else b"")
                + struct.pack("<QQ", UNDEF, UNDEF) + (struct.pack("<Q", UNDEF) if bits & 2 else b""))
        gflags, ginfo = self._group_info or (1, b"\0\0")
        most, least = struct.unpack_from("<HH", ginfo, 2) if ginfo[1] & 1 else (LINK_MAX_COMPACT, LINK_MIN_DENSE)
        estimates = ginfo[6 if ginfo[1] & 1 else 2:][:4] if ginfo[1] & 2 else b""
        phase_bit = ginfo[1] & 1
        if len(links) > most:
            most, least, phase_bit = len(links), min(least, len(links)), 1
        ginfo = bytes([0, phase_bit | (ginfo[1] & 2)]) + (struct.pack("<HH", most, least) if phase_bit else b"") + estimates
        out = [(LINK_INFO, info_flags, body, 0), (GROUP_INFO, gflags, ginfo, 0)]
        for name, target in links.items():
            if isinstance(target, _Link):
                out.append((LINK, 0, self._link_raw[name], 0))
            else:
                out.append((LINK, 0, _link_bytes(name, target, self._link_corder[name] if bits & 1 else None), 0))
        return out

    def _write_symbol_table(self) -> None:
        """A local heap of the names, symbol-table nodes of up to 2 K_leaf
        entries each, and a B-tree over them, all at the end of the file."""
        f = self._file
        names = sorted(self._links, key=lambda n: n.encode("utf-8"))  # HDF5 bisects
        heap, offsets, soft = bytearray(8), {}, {}  # offset 0 holds the empty string
        for name in names:
            offsets[name] = len(heap)
            heap += _padded(name.encode("utf-8") + b"\0")
        for name in names:
            if isinstance(self._links[name], _Link):  # a soft link's value goes in the heap too
                soft[name] = len(heap)
                heap += _padded(self._links[name].target.encode("utf-8") + b"\0")
        heap_addr = f._alloc(32 + len(heap))
        f._write(heap_addr, struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), 1, heap_addr + 32) + bytes(heap))
        cap = 2 * f._leaf_k
        snod_size = 8 + 40 * cap
        groups = [names[i:i + cap] for i in range(0, len(names), cap)]
        snod_addrs = []
        for members in groups:
            node = bytearray(snod_size)
            struct.pack_into("<4sBxH", node, 0, b"SNOD", 1, len(members))
            for j, name in enumerate(members):
                obj = self._objs.get(name)
                target = self._links[name]
                if isinstance(obj, Group) and obj._stab:  # a group's entry caches its symbol table, as HDF5's do
                    cache = struct.pack("<IIQQ", 1, 0, obj._btree, obj._heap)
                elif name in soft:
                    cache, target = struct.pack("<IIIIQ", 2, 0, soft[name], 0, 0), UNDEF
                elif obj is None and name in self._cache:
                    cache = self._cache[name]
                else:
                    cache = bytes(24)
                node[8 + 40 * j:48 + 40 * j] = struct.pack("<QQ", offsets[name], target) + cache
            snod_addrs.append(f._append(bytes(node)))
        # the keys: heap offsets of the empty string, then of each node's last name
        left = [0] + [offsets[m[-1]] for m in groups[:-1]]
        right = [offsets[m[-1]] for m in groups]
        self._btree = _write_btree(f, 0, f._internal_k, snod_addrs, left, right, lambda off: struct.pack("<Q", off),
                                   empty_key=struct.pack("<Q", 0))
        self._heap = heap_addr


def _local_heap(f: File, addr: int) -> bytes:
    """The data segment of the local heap at ``addr`` (III.D: ``HEAP``, its
    version, 3 reserved bytes, the segment's size, the free list's offset,
    the segment's address)."""
    head = f._read(addr, 8 + 2 * f._sl + f._so)
    if head[:4] != b"HEAP":
        raise FormatError(f"{f.path}: no local heap at {addr}")
    return f._read(f._addr(head, 8 + 2 * f._sl), f._length(head, 8))


def _write_btree(f: File, node_type: int, k: int, children: List[int], left, right, encode_key,
                 empty_key: bytes) -> int:
    """A version-1 B-tree over ``children`` (level 0), each between its
    left and right key, with as many levels as 2 K children per node need;
    siblings linked on every level. Its root's address."""
    key_size = len(empty_key)
    node_size = 24 + 2 * k * 8 + (2 * k + 1) * key_size
    level = 0
    if not children:
        node = bytearray(node_size)
        struct.pack_into("<4sBBHQQ", node, 0, b"TREE", node_type, 0, 0, UNDEF, UNDEF)
        node[24:24 + key_size] = empty_key
        return f._append(bytes(node))
    while True:
        groups = [range(i, min(i + 2 * k, len(children))) for i in range(0, len(children), 2 * k)]
        addrs = [f._alloc(node_size) for _ in groups]
        for g, (members, addr) in enumerate(zip(groups, addrs)):
            node = bytearray(node_size)
            struct.pack_into("<4sBBHQQ", node, 0, b"TREE", node_type, level, len(members),
                             addrs[g - 1] if g else UNDEF, addrs[g + 1] if g + 1 < len(addrs) else UNDEF)
            pos = 24
            for j in members:
                node[pos:pos + key_size] = encode_key(left[j])
                struct.pack_into("<Q", node, pos + key_size, children[j])
                pos += key_size + 8
            node[pos:pos + key_size] = encode_key(right[members[-1]])
            f._write(addr, bytes(node))
        if len(addrs) == 1:
            return addrs[0]
        left = [left[m[0]] for m in groups]
        right = [right[m[-1]] for m in groups]
        children, level = addrs, level + 1


# --------------------------------------------------------------------------
# datasets (IV.A.2.b, d, e, f, i, l)
# --------------------------------------------------------------------------


def _fill_value(mtype: int, body: bytes) -> Optional[bytes]:
    """The fill value of an old (type 4) or new (type 5, versions 1-3)
    fill-value message, or None when it is undefined or left to the default."""
    if mtype == FILL_OLD:
        n = struct.unpack_from("<I", body, 0)[0]
        return body[4:4 + n] if n else None
    version = body[0]
    if version in (1, 2):
        if version == 2 and not body[3]:
            return None
        n = struct.unpack_from("<I", body, 4)[0]
        return body[8:8 + n] if n else None
    if version == 3:
        if not body[1] & 0x20:
            return None
        n = struct.unpack_from("<I", body, 2)[0]
        return body[6:6 + n] if n else None
    raise FormatError(f"fill-value message version {version} is not one this codec reads")


class _DimensionProxy:
    """One axis of a dataset's dimension scales (h5py's ``ds.dims[i]``):
    ``items()`` [(the scale's NAME, the scale)], ``attach_scale``."""

    def __init__(self, ds: "Dataset", axis: int):
        self._ds, self._axis = ds, axis

    def items(self) -> List[Tuple[str, "Dataset"]]:
        ds = self._ds
        if "DIMENSION_LIST" not in ds.attrs:
            return []
        refs = ds.attrs["DIMENSION_LIST"][self._axis]
        out = []
        for addr in np.asarray(refs).tolist():
            scale = ds._file.deref(int(addr))
            name = scale.attrs.get("NAME", b"")
            out.append((name.decode("utf-8") if isinstance(name, bytes) else str(name), scale))
        return out

    def attach_scale(self, scale: "Dataset") -> None:
        """Attach ``scale`` to this axis as HDF5's ``H5DSattach_scale`` does:
        its object reference appended to the axis' entry of the dataset's
        ``DIMENSION_LIST`` (a variable-length sequence per axis, in the
        global heap) and (the dataset's reference, the axis) to the scale's
        ``REFERENCE_LIST``. Both are encoded when the headers are written,
        once every object has its address."""
        ds, axis = self._ds, self._axis
        ds._check_writable()
        scale._check_writable()
        if ds._dim_scales is None:
            ds._dim_scales = [[] for _ in ds._shape]
            ds._dim_heap = [None] * len(ds._shape)
            ds._set_attr_raw("DIMENSION_LIST", ds._dimension_list)
            ds._file._attached.append(ds)
        if scale in ds._dim_scales[axis]:
            return
        ds._dim_scales[axis].append(scale)
        if scale._ref_list is None:
            scale._ref_list = []
            scale._set_attr_raw("REFERENCE_LIST", scale._reference_list)
        scale._ref_list.append((ds, axis))
        ds._dirty = scale._dirty = True


# REFERENCE_LIST's element: an object reference and an int, as H5DS lays it out
REF_LIST_TYPE = compound_type_bytes([("dataset", 0, OBJ_REF_TYPE), ("dimension", 8, type_bytes(np.int32))], 16)


class Dataset(_Object):
    """A dataset, read whole (``read()``, ``ds[()]``) or through a region
    reference (``ds[ref]``); a 1-D chunked one written by this codec is
    appended to. Its data may lie in the file (compact, contiguous,
    chunked), in external files (``_read_external``) or in other datasets
    (virtual, ``_read_virtual``)."""

    def __init__(self, file: File, addr: Optional[int], msgs=(), hflags: int = 0):
        super().__init__(file, addr, msgs, hflags)
        self._unreadable = None  # why read and append refuse this dataset, if they do
        self._chunks = None  # (offsets [n, rank], addresses, sizes, filter masks), read when first needed
        self._chunks_dirty = False
        self._filters: list = []
        self._fill: Optional[bytes] = None
        self._index = self._data_addr = UNDEF
        self._kind = self._compact = self._chunk = None
        # a version-4 layout's chunk index: its type (CHUNK_INDEXES), the
        # layout's flags and, for a single chunk, its filtered size and mask
        self._index_type, self._layout_flags, self._single = None, 0, None
        self._external: Optional[bytes] = None  # the external data files message, where the data lie in files of their own
        self._vds: Optional[Tuple[int, int]] = None  # a virtual dataset's mappings: (collection, index) in the global heap
        self._shape = self._maxshape = None
        self._type: Optional[Type] = None
        self._dim_scales = self._ref_list = None  # what this codec attaches, when writing
        self._dim_heap = None  # DIMENSION_LIST's objects per axis: (count, collection, index, file position)
        if addr is None:
            return
        fill_new = fill_old = None
        what = f"{file.path}: the dataset at {addr}"
        for mtype, flags, body in self._msgs:
            if flags & 2:  # shared: a committed datatype, or a message in the shared-message table
                try:
                    if mtype == DATATYPE:
                        self._type = file._shared_type(body, what)
                        continue
                    body = file._shared_message(mtype, body, what)
                except FormatError as e:
                    self._unreadable = str(e)
                    continue
            if mtype == DATASPACE:
                self._shape, self._maxshape = parse_space(body, file._sl)
            elif mtype == DATATYPE:
                self._type, _ = parse_type(body)
            elif mtype == FILL:
                fill_new = _fill_value(mtype, body)
            elif mtype == FILL_OLD:
                fill_old = _fill_value(mtype, body)
            elif mtype == FILTERS:
                self._filters = parse_filters(body)
            elif mtype == EXTERNAL:
                self._external = body
            elif mtype == LAYOUT:
                self._parse_layout(body)
        self._fill = fill_new if fill_new is not None else fill_old
        if self._unreadable is None and self._filters:
            bad = check_filters(self._filters)
            if bad:
                self._unreadable = f"{file.path}: the dataset at {addr}: {bad}"

    def _parse_layout(self, body: bytes) -> None:
        """The data layout message (IV.A.2.i), versions 1 to 4: compact,
        contiguous and chunked data, chunks under a version-1 B-tree
        (versions 1 to 3) or any version-4 chunk index, and virtual data
        (version 4: its mappings' global heap object)."""
        version = body[0]
        f = self._file
        where = f"{f.path}: the dataset at {self._addr}"
        if version in (1, 2):
            ndims, cls = body[1], body[2]
            pos = 8
            if cls in (1, 2):
                addr = f._addr(body, pos)
                pos += f._so
            dims = struct.unpack_from(f"<{ndims}I", body, pos)
            pos += 4 * ndims
            if cls == 0:
                n = struct.unpack_from("<I", body, pos)[0]
                self._kind, self._compact = "compact", body[pos + 4:pos + 4 + n]
            elif cls == 1:
                self._kind, self._data_addr = "contiguous", addr
            else:
                self._kind, self._index, self._chunk = "chunked", addr, tuple(dims[:-1])
            return
        if version not in (3, 4):
            self._unreadable = f"{where} has a layout message of version {version}"
            return
        cls = body[1]
        if cls == 0:
            n = struct.unpack_from("<H", body, 2)[0]
            self._kind, self._compact = "compact", body[4:4 + n]
        elif cls == 1:
            self._kind, self._data_addr = "contiguous", f._addr(body, 2)
        elif cls == 2 and version == 3:
            ndims = body[2]
            self._kind, self._index = "chunked", f._addr(body, 3)
            self._chunk = tuple(struct.unpack_from(f"<{ndims}I", body, 3 + f._so)[:-1])
        elif cls == 2:
            # flags (bit 0: partial edge chunks not filtered; bit 1: a single
            # chunk's filtered size and mask follow), the chunk's dims (the
            # element size last) in ``width`` bytes each, the index type, its
            # parameters, the index's address
            flags, ndims, width = body[2], body[3], body[4]
            dims = [int.from_bytes(body[5 + i * width:5 + (i + 1) * width], "little") for i in range(ndims)]
            pos = 5 + ndims * width
            index = body[pos]
            pos += 1
            if index == 1:
                if flags & 2:
                    self._single = (f._length(body, pos), struct.unpack_from("<I", body, pos + f._sl)[0])
                    pos += f._sl + 4
            elif index in (3, 4, 5):
                pos += {3: 1, 4: 5, 5: 6}[index]  # the index's parameters: its own header holds them too
            elif index != 2:
                self._unreadable = f"{where} has a version-4 layout with a chunk index of type {index}"
                return
            self._kind, self._chunk, self._index_type, self._layout_flags = "chunked", tuple(dims[:-1]), index, flags
            self._index = f._addr(body, pos)
        elif cls == 3 and version == 4:
            self._kind, self._vds = "virtual", (f._addr(body, 2), struct.unpack_from("<I", body, 2 + f._so)[0])
        else:
            self._unreadable = f"{where} has a layout of class {cls}, version {version}"

    # --- the surface ---
    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape or ())

    @property
    def dtype(self) -> np.dtype:
        self._check_readable()
        return self._type.dtype

    @property
    def chunks(self) -> Optional[Tuple[int, ...]]:
        return self._chunk if self._kind == "chunked" else None

    @property
    def dims(self) -> List[_DimensionProxy]:
        return [_DimensionProxy(self, axis) for axis in range(self.ndim)]

    def make_scale(self, name: str) -> None:
        """Make this dataset a dimension scale, as HDF5's ``H5DSset_scale``
        does: ``CLASS`` "DIMENSION_SCALE" and ``NAME`` as null-terminated
        fixed-length strings."""
        for attr, text in (("CLASS", DIM_SCALE_CLASS), ("NAME", name.encode("utf-8"))):
            tb = string_type_bytes(len(text) + 1)
            self._set_attr_raw(attr, _attr_bytes(attr, tb, space_bytes(()), text + b"\0"))

    def _place_dimension_list(self) -> List[Tuple[int, bytes]]:
        """Put DIMENSION_LIST's sequences in the global heap, once every
        object has its address: an axis' first sequence, or one that has
        gained a scale since, as a new object (its dataset's header is then
        being rewritten); else the same object, its bytes rewritten in place
        where a scale has moved, so that flushing again leaves no orphaned
        objects. The (file position, bytes) of those rewrites."""
        f, rewrites, new = self._file, [], []
        for axis, scales in enumerate(self._dim_scales):
            blob = np.array([s._addr for s in scales], dtype="<u8").tobytes()
            held = self._dim_heap[axis]
            if held is not None and held[0] == len(scales):
                _, col, idx, pos = held
                if f._gcols[col][idx] != blob:
                    f._gcols[col][idx] = blob
                    rewrites.append((pos, blob))
            elif scales:
                new.append((axis, blob))
        if new:
            addrs, idxs, at = f._gheap_put([blob for _, blob in new])
            for j, (axis, _) in enumerate(new):
                self._dim_heap[axis] = (len(self._dim_scales[axis]), int(addrs[j]), int(idxs[j]), int(at[j]))
        return rewrites

    def _dimension_list(self, final: bool) -> bytes:
        """DIMENSION_LIST: per axis a variable-length sequence of object
        references to its scales, the sequences in the global heap (placed
        by ``_place_dimension_list``)."""
        refs = np.zeros(len(self._dim_scales), dtype=VLEN_REF)
        if final:
            for axis, held in enumerate(self._dim_heap):
                if held is not None:
                    refs[axis] = held[:3]
        tb = vlen_seq_type_bytes(OBJ_REF_TYPE)
        return _attr_bytes("DIMENSION_LIST", tb, _simple_space((len(refs),)), refs.tobytes())

    def _reference_list(self, final: bool) -> bytes:
        """REFERENCE_LIST: (object reference, axis) of every attachment."""
        rows = np.zeros(len(self._ref_list), dtype=np.dtype({"names": ["dataset", "dimension"],
                                                             "formats": ["<u8", "<i4"], "offsets": [0, 8],
                                                             "itemsize": 16}))
        if final:
            rows["dataset"] = [ds._addr for ds, _ in self._ref_list]
            rows["dimension"] = [axis for _, axis in self._ref_list]
        return _attr_bytes("REFERENCE_LIST", REF_LIST_TYPE, _simple_space((len(rows),)), rows.tobytes())

    def _check_readable(self):
        if self._unreadable:
            raise FormatError(self._unreadable)
        self._type.check(f"{self._file.path}: dataset {self.name or self._addr}")

    def __getitem__(self, key):
        if isinstance(key, RegionReference):
            return self._region(key)
        data = self.read()
        if key is Ellipsis:
            return data
        return data[key]  # ds[()] of a scalar is its value, as h5py gives it

    def _region(self, ref: RegionReference):
        """The elements a region reference selects in this dataset, in
        HDF5's order and h5py's shape (``Selection.shape``)."""
        if ref.addr != self._addr:
            raise ValueError(f"{self._file.path}: the region reference names the object at {ref.addr}, not "
                             f"dataset {self.name or self._addr}")
        data = self.read()
        if self._shape is None or not self._shape:
            return data
        return ref.selection.take(data).reshape(ref.selection.shape(self._shape))

    def read(self):
        """The whole dataset (``Empty`` for a null dataspace)."""
        self._check_readable()
        t, f = self._type, self._file
        if self._shape is None:
            return Empty(t.dtype)
        if self._kind == "virtual":
            return self._read_virtual()
        shape, n = self._shape, int(np.prod(self._shape))
        full = shape + t.storage.shape  # an array datatype's dims after the dataset's, as numpy lays them out
        if self._external is not None:
            raw = np.frombuffer(self._read_external(n * t.storage.itemsize), dtype=t.storage,
                                count=n).reshape(full).copy()
        elif self._kind == "compact":
            raw = np.frombuffer(self._compact, dtype=t.storage, count=n).reshape(full).copy()
        elif self._kind == "contiguous":
            if self._data_addr == UNDEF or n == 0:
                raw = self._filled(shape)
            else:
                raw = f._read_array(self._data_addr, t.storage, n).reshape(full)
        else:
            raw = self._read_chunked()
        return f._decode(raw, t)

    def _read_external(self, nbytes: int) -> bytes:
        """The data in external files (the external data files message,
        IV.A.2.h: version, the slots allocated and used, the local heap of
        their names; per slot the name's offset in it, an offset in that
        file and a size): laid end to end across the slots, bytes past a
        file's end zeros and past the slots the fill value. A relative name
        is relative to the working directory, where HDF5 looks by default
        (no efile prefix set or in the environment)."""
        f, body = self._file, self._external
        where = f"{f.path}: dataset {self.name or self._addr}"
        if body[0] != 1:
            raise FormatError(f"{where}: an external data files message of version {body[0]}")
        used = struct.unpack_from("<H", body, 6)[0]
        names = _local_heap(f, f._addr(body, 8))
        parts, got, pos = [], 0, 8 + f._so
        for i in range(used):
            name_off, offset, size = (f._length(body, pos + f._sl * k) for k in range(3))
            pos += 3 * f._sl
            want = min(size, nbytes - got)  # an unlimited slot's size is UNDEF
            if want <= 0:
                break
            name = names[name_off:names.index(b"\0", name_off)].decode("utf-8")
            try:
                with open(name, "rb") as fh:
                    fh.seek(offset)
                    data = fh.read(want)
            except FileNotFoundError:
                raise FormatError(f"{where}: its external file {name!r} (slot {i}) is not found from the working "
                                  f"directory {os.getcwd()}") from None
            parts.append(data + b"\0" * (want - len(data)))
            got += want
        data = b"".join(parts)
        if got < nbytes:
            data += self._filled(self._shape).tobytes()[got:]
        return data

    def _virtual_mappings(self) -> List[Tuple[str, str, Selection, Selection]]:
        """A virtual dataset's mappings (its global heap object, version 0:
        the count of mappings in the file's size of lengths, then each one's
        source file and dataset names, null-terminated, and its source and
        virtual selections; a checksum last). "%%" in a name is "%"; a
        printf-style name ("%b") or an unlimited selection is refused."""
        f = self._file
        where = f"{f.path}: virtual dataset {self.name or self._addr}"
        blob = f._gheap_object(*self._vds)
        check_sum(blob, f.path, f"the mappings of {where}")
        if blob[0] != 0:
            raise FormatError(f"{where}: mappings of encoding version {blob[0]}; this codec reads version 0")
        count, pos, out = f._length(blob, 1), 1 + f._sl, []
        for _ in range(count):
            names = []
            for _ in range(2):
                end = blob.index(b"\0", pos)
                names.append(blob[pos:end].decode("utf-8"))
                pos = end + 1
            src_sel, pos = parse_selection(blob, pos)
            vsel, pos = parse_selection(blob, pos)
            for label, name in zip(("source file", "source dataset"), names):
                if "%b" in name:
                    raise FormatError(f"{where}: a printf-style {label} name {name!r} (%b, the block of an "
                                      "unlimited mapping); this codec reads fixed mappings")
            if src_sel.unlimited or vsel.unlimited:
                raise FormatError(f"{where}: an unlimited mapping of {names[0]}:{names[1]}; this codec reads fixed "
                                  "mappings")
            out.append((names[0].replace("%%", "%"), names[1].replace("%%", "%"), src_sel, vsel))
        return out

    def _read_virtual(self) -> np.ndarray:
        """A virtual dataset (IV.A.2.i, class 3): the fill value, then each
        mapping's source selection copied, element by element in order, into
        its virtual selection. The source file "." is this file; another is
        looked for as HDF5 looks by default: where given if absolute (then
        by its last component), in this file's directory, then as given
        from the working directory. A missing source file or dataset leaves
        its elements the fill value, as h5py reads it."""
        f = self._file
        out = f._decode(self._filled(self._shape), self._type)
        for file_name, ds_name, src_sel, vsel in self._virtual_mappings():
            src = f._source(file_name)
            if src is None or ds_name not in src:
                continue
            ds = src[ds_name]
            if not isinstance(ds, Dataset) or ds.shape is None:
                raise FormatError(f"{f.path}: the source {file_name}:{ds_name} of virtual dataset "
                                  f"{self.name or self._addr} is not a dataset with data")
            try:
                vsel.put(out, src_sel.take(np.asarray(ds.read())))
            except (IndexError, ValueError) as e:
                raise FormatError(f"{f.path}: virtual dataset {self.name or self._addr}: the mapping of "
                                  f"{file_name}:{ds_name} does not fit: {e}") from None
        return out

    def _filled(self, shape) -> np.ndarray:
        """An array of ``shape`` holding the fill value (zeros if none)."""
        storage = self._type.storage
        out = np.zeros(shape, dtype=storage)
        fill = self._fill
        if fill is not None and len(fill) == storage.itemsize and self._type.vlen is None and any(fill):
            out.reshape(-1).view(np.uint8).reshape(-1, storage.itemsize)[:] = np.frombuffer(fill, np.uint8)
        return out

    def _read_chunked(self) -> np.ndarray:
        t, f = self._type, self._file
        shape, cdims = self._shape, self._chunk
        out = self._filled(shape)
        offsets, addrs, sizes, masks = self._chunk_index()
        esize = t.storage.itemsize
        csize = int(np.prod(cdims)) * esize
        inside = np.all(offsets < np.asarray(shape, dtype=np.uint64), axis=1) if len(offsets) else np.zeros(0, bool)
        offsets, addrs, sizes, masks = offsets[inside], addrs[inside], sizes[inside], masks[inside]
        if len(shape) == 1 and not self._filters and len(offsets):
            # runs of unfiltered chunks that lie end to end in the file are read at once
            c, n = cdims[0], shape[0]
            offs, locs = offsets[:, 0].astype(np.int64), addrs.astype(np.int64)
            brk = np.flatnonzero((np.diff(locs) != c * esize) | (np.diff(offs) != c)) + 1
            for s, e in zip(np.r_[0, brk], np.r_[brk, len(offs)]):
                lo, hi = int(offs[s]), min(int(offs[e - 1]) + c, n)
                out[lo:hi] = f._read_array(int(locs[s]), t.storage, hi - lo)
            return out
        where = f"{f.path}: dataset {self.name or self._addr}"
        for j in np.argsort(addrs, kind="stable").tolist():
            buf = f._read(int(addrs[j]), int(sizes[j]))
            if self._filters:
                buf = unfilter(buf, self._filters, int(masks[j]), esize, where, csize)
            if len(buf) != csize:
                raise FormatError(f"{where}: a chunk of {len(buf)} bytes where {csize} were expected")
            chunk = np.frombuffer(buf, dtype=t.storage).reshape(cdims + t.storage.shape)
            lo = offsets[j].astype(np.int64)
            hi = np.minimum(lo + np.asarray(cdims), np.asarray(shape))
            out[tuple(slice(a, b) for a, b in zip(lo, hi))] = chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
        return out

    def append(self, data) -> None:
        """Add ``data``'s rows at the end of a 1-D chunked, resizable
        dataset. The last chunk's free rows are filled in place where it is
        stored unfiltered; else it is decoded, filled, sent through the
        dataset's filters again and written at the end of the file. The rest
        go into new chunks at the end of the file, each through the filters,
        the rows past the data holding the fill value. A version-4 layout's
        chunks are carried over, at their addresses and with their filter
        masks, to a version-1 B-tree under a version-3 layout, the form HDF5
        reads in every superblock. Refusals come before anything is written."""
        f = self._file
        self._check_writable()
        if self._unreadable:
            raise f._refuse(self._unreadable)
        if self._kind == "virtual" or self._external is not None:
            what = "a virtual dataset" if self._vds else "stored in external files"
            raise f._refuse(f"{f.path}: the dataset at {self._addr} is {what}; this codec reads it and does not "
                            "append to it")
        if self._kind != "chunked" or self._maxshape is None or len(self._shape) != 1 or self._maxshape[0] != UNDEF:
            raise f._refuse(f"{f.path}: the dataset at {self._addr} is not resizable", OSError)
        bad = unencodable(self._filters)
        if bad:
            raise f._refuse(f"{f.path}: the dataset at {self._addr}: {bad}")
        t = self._type
        try:
            t.check(f"{f.path}: dataset at {self._addr}")
        except FormatError as e:
            raise f._refuse(str(e)) from None
        data = np.asarray(data)
        if data.ndim != 1:
            raise ValueError(f"append: 1-D data expected, got shape {data.shape}")
        raw = f._encode_vlen_str(data) if t.vlen_str else np.ascontiguousarray(data, dtype=t.storage)
        offsets, addrs, sizes, masks = (a.astype(np.uint64) for a in self._chunk_index())
        offsets, masks = offsets[:, 0], masks.astype(np.uint32)
        if self._index_type is not None:  # from here on under a version-1 B-tree
            self._index_type, self._layout_flags, self._single = None, 0, None
        n_old, c, esize = self._shape[0], self._chunk[0], t.storage.itemsize
        used = n_old % c
        n_done = n_old
        if used and len(raw):
            last, k = n_old - used, min(c - used, len(raw))
            hit = np.flatnonzero(offsets == last)
            if len(hit) and not self._filters:
                f._write(int(addrs[hit[0]]) + used * esize, raw[:k].tobytes())
            else:  # a filtered chunk is decoded, filled and encoded anew; a chunk never written, filled
                chunk = self._chunk_rows(int(addrs[hit[0]]), int(sizes[hit[0]]), int(masks[hit[0]])) if len(hit) \
                    else self._filled((c,))
                chunk[used:used + k] = raw[:k]
                blob, mask = self._encode(chunk)
                if len(hit):
                    addrs[hit[0]], sizes[hit[0]], masks[hit[0]] = f._append(blob), len(blob), mask
                else:
                    offsets, addrs = np.r_[offsets, last], np.r_[addrs, f._append(blob)]
                    sizes, masks = np.r_[sizes, len(blob)], np.r_[masks, mask]
            raw = raw[k:]
            n_done = n_old + k
        if len(raw):
            count = -(-len(raw) // c)
            buf = self._filled((count * c,))
            buf[:len(raw)] = raw
            new_off = n_done + c * np.arange(count, dtype=np.uint64)
            if not self._filters:
                base = f._append(buf.tobytes())
                new_addr = base + c * esize * np.arange(count, dtype=np.uint64)
                new_size, new_mask = np.full(count, c * esize, np.uint64), np.zeros(count, np.uint32)
            else:  # each chunk through the filters, all written at once, end to end
                blobs, new_mask = zip(*(self._encode(buf[j * c:(j + 1) * c]) for j in range(count)))
                new_size = np.array([len(blob) for blob in blobs], np.uint64)
                room = (new_size + np.uint64(7)) & ~np.uint64(7)
                base = f._append(b"".join(_padded(blob) for blob in blobs))
                new_addr = base + np.concatenate([[0], np.cumsum(room)[:-1]]).astype(np.uint64)
                new_mask = np.array(new_mask, np.uint32)
            offsets, addrs = np.r_[offsets, new_off], np.r_[addrs, new_addr]
            sizes, masks = np.r_[sizes, new_size], np.r_[masks, new_mask]
        order = np.argsort(offsets, kind="stable")
        self._chunks = (offsets[order].reshape(-1, 1).astype(np.uint64), addrs[order].astype(np.uint64),
                        sizes[order].astype(np.uint64), masks[order].astype(np.uint32))
        self._shape = (n_done + len(raw),)
        self._replace_msg(DATASPACE, space_bytes(self._shape, self._maxshape))
        self._chunks_dirty = self._dirty = True

    def _chunk_rows(self, addr: int, size: int, mask: int) -> np.ndarray:
        """One stored chunk's rows, through the filters its mask leaves on."""
        f, t = self._file, self._type
        buf = f._read(addr, size)
        csize = self._chunk[0] * t.storage.itemsize
        if self._filters:
            buf = unfilter(buf, self._filters, mask, t.storage.itemsize, f"{f.path}: dataset {self.name}", csize)
        if len(buf) != csize:
            raise FormatError(f"{f.path}: dataset {self.name}: a chunk of {len(buf)} bytes where {csize} were "
                              "expected")
        return np.frombuffer(buf, dtype=t.storage).copy()

    def _encode(self, rows: np.ndarray) -> Tuple[bytes, int]:
        """A chunk's bytes through the dataset's filters, and its mask."""
        if not self._filters:
            return rows.tobytes(), 0
        return filter_chunk(rows.tobytes(), self._filters, self._type.storage.itemsize)

    # --- the chunk index (III.A.1, B-tree type 1; IV.A.2.i) ---
    def _chunk_index(self):
        """(offsets [n, rank], addresses, sizes, filter masks) of the chunks
        written, in offset order."""
        if self._chunks is None and self._index_type is not None:
            self._chunks = self._v4_chunks()
        if self._chunks is None:
            rank = len(self._chunk)
            # a key (the chunk's size, its filter mask, its offsets at 8 bytes each) and a child's address
            entry = np.dtype([("size", "<u4"), ("mask", "<u4"), ("offs", "<u8", (rank + 1,)),
                              ("child", f"<u{self._file._so}")])
            rows = [np.zeros(0, entry)]
            if self._index != UNDEF:
                self._walk_chunks(self._index, entry, rows)
            arr = np.concatenate(rows)
            arr = arr[np.lexsort(arr["offs"][:, :rank].T[::-1])] if len(arr) else arr
            self._chunks = (arr["offs"][:, :rank].copy(), arr["child"].astype(np.uint64), arr["size"].copy(),
                            arr["mask"].copy())
        return self._chunks

    def _v4_chunks(self):
        """The chunks under a version-4 layout's index. Element indices run
        in row-major order over the chunk grid of the maximum dims; an
        extensible array's over dims reordered so that the unlimited one
        comes first (``H5VM_swizzle_coords``). With the layout's flag bit 0
        a partial edge chunk is stored unfiltered: its mask is given every
        bit."""
        f, rank, addr = self._file, len(self._chunk), self._index
        cdims = np.asarray(self._chunk, dtype=np.int64)
        shape = np.asarray(self._shape, dtype=np.int64)
        maxshape = self._maxshape or self._shape
        nbytes = int(np.prod(cdims)) * self._type.storage.itemsize
        grid = [-(-int(m) // int(c)) if m != UNDEF else 0 for m, c in zip(maxshape, cdims)]
        order = list(range(rank))
        sizes = masks = None
        if addr == UNDEF:
            keys, addrs = np.zeros(0, np.int64), np.zeros(0, np.uint64)
        elif self._index_type == 1:  # one chunk at the address: the whole dataset
            keys, addrs = np.zeros(1, np.int64), np.array([addr], np.uint64)
            if self._single is not None:
                sizes, masks = np.array([self._single[0]], np.uint64), np.array([self._single[1]], np.uint32)
        elif self._index_type == 2:  # implicit: every chunk of the grid, end to end
            keys = np.arange(int(np.prod(grid)), dtype=np.int64)
            addrs = (addr + keys * nbytes).astype(np.uint64)
        elif self._index_type == 3:
            keys, addrs, sizes, masks = fixed_array_chunks(f._read, addr, f.path, f._so, f._sl)
        elif self._index_type == 4:
            unlim = [i for i, m in enumerate(maxshape) if m == UNDEF]
            if len(unlim) != 1:
                raise FormatError(f"{f.path}: an extensible array chunk index over {len(unlim)} unlimited dims")
            order = unlim + [i for i in range(rank) if i != unlim[0]]
            keys, addrs, sizes, masks = extensible_array_chunks(f._read, addr, f.path, f._so, f._sl)
        else:
            keys, addrs, sizes, masks = btree2_chunks(f._read, addr, f.path, rank, f._so, f._sl)
        if keys.ndim == 1:  # element indices -> scaled offsets, the first of ``order`` varying slowest
            inner = [grid[i] for i in order[1:]]
            slow, rest = np.divmod(keys, int(np.prod(inner)))
            scaled = np.zeros((len(keys), rank), np.int64)
            scaled[:, order] = np.column_stack([slow, *(np.unravel_index(rest, inner) if inner else ())])
        else:
            scaled = keys
        offsets = scaled * cdims
        if sizes is None:
            sizes, masks = np.full(len(addrs), nbytes, np.uint64), np.zeros(len(addrs), np.uint32)
        if self._layout_flags & 1 and len(offsets):
            masks = np.where(np.any(offsets + cdims > shape, axis=1), np.uint32(0xFFFFFFFF), masks)
        sort = np.lexsort(offsets.T[::-1]) if len(offsets) else np.zeros(0, np.int64)
        return (offsets[sort].astype(np.uint64), addrs[sort].astype(np.uint64), sizes[sort].astype(np.uint64),
                masks[sort].astype(np.uint32))

    def _walk_chunks(self, addr: int, entry: np.dtype, rows: list) -> None:
        f = self._file
        head = f._read(addr, 8 + 2 * f._so)  # signature, type, level, entries, the siblings' addresses
        if head[:4] != b"TREE" or head[4] != 1:
            raise FormatError(f"{f.path}: no chunk B-tree node at {addr}")
        level, n = head[5], struct.unpack_from("<H", head, 6)[0]
        found = np.frombuffer(f._read(addr + 8 + 2 * f._so, entry.itemsize * n), dtype=entry, count=n)
        if level:
            for child in found["child"].tolist():
                self._walk_chunks(child, entry, rows)
            return
        rows.append(found)

    # --- writing ---
    def _replace_msg(self, mtype: int, body: bytes) -> None:
        self._msgs = [(m, fl, body if m == mtype else b) for m, fl, b in self._msgs]

    def _set_attr(self, name: str, value) -> None:
        if self._unreadable:
            raise self._file._refuse(self._unreadable)
        super()._set_attr(name, value)

    def _assign(self) -> bool:
        if self._chunks_dirty:
            self._write_chunk_btree()
            self._chunks_dirty = False
        return super()._assign()

    def _write_chunk_btree(self) -> None:
        offsets, addrs, sizes, masks = self._chunks
        offsets = offsets[:, 0]
        if not len(offsets):
            self._index = UNDEF
        else:
            # a key: the chunk's byte size, its filter mask, its offset and the
            # offset in the element's bytes, 0. A chunk's right key is the next
            # chunk's key; the last one's, as HDF5 makes it, is one chunk further
            # on in every dimension: its offset plus a chunk, and the element size
            lefts = list(zip(sizes.tolist(), masks.tolist(), offsets.tolist(), [0] * len(offsets)))
            rights = lefts[1:] + [(0, 0, int(offsets[-1]) + self._chunk[0], self._type.storage.itemsize)]
            self._index = _write_btree(self._file, 1, self._file._chunk_k, addrs.tolist(), lefts, rights,
                                       lambda key: struct.pack("<IIQQ", *key), empty_key=b"\0" * 24)
        self._replace_msg(LAYOUT, struct.pack("<BBBQII", 3, 2, 2, self._index, self._chunk[0],
                                              self._type.storage.itemsize))
