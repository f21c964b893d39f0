"""A reader and writer for the subset of HDF5 that ``TableStore`` files use.

Written in numpy and ``struct``; it needs no HDF5 library. It reads and
writes HDF5's earliest file format, the one h5py writes unless asked for a
later one:

- superblock version 0, 8-byte addresses and lengths;
- version-1 object headers, with continuation blocks when reading;
- groups as symbol tables: a version-1 B-tree of type 0 over symbol-table
  nodes (``SNOD``) whose names live in a local heap;
- 1-D chunked datasets (layout class 2, an unlimited maximum, a version-1
  B-tree of type 1 over the chunks);
- fixed-point and floating-point numbers and variable-length strings,
  whose bytes live in global heap collections;
- attributes in the object header (compact storage).

Writing keeps what is on disk valid until the superblock is rewritten:
chunks and global heap objects go to the end of the file as they come, and
at ``close`` every object whose metadata changed gets a new object header
(and, for a dataset, a new chunk B-tree; for a group, a new symbol table) at
the end of the file, its parents up to the root likewise, and last the
superblock points at the new root. Space left behind is not reused, as HDF5
does not reuse it without a free-space manager. h5py and the HDF5 library
read such a file and can append to it.

A file this codec does not read (a later superblock or object-header
version, new-style groups, a contiguous or compressed dataset, a compound
datatype) raises ``FormatError``, an ``OSError``, which names what it
found; a group of such datasets is still listed and its attributes read.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF  # the undefined address, and H5S_UNLIMITED
GROUP_LEAF_K, GROUP_INTERNAL_K = 4, 16  # HDF5's defaults, in every superblock this codec writes
CHUNK_K = 32  # the chunk B-tree's K: fixed by a version-0 superblock
GHEAP_MIN = 4096  # the least size of a global heap collection
GHEAP_MAX_OBJECTS = 0xFFFF  # object indices are 16 bits; 0 is the free space
SUPERBLOCK_SIZE = 96

# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL, LINK, LAYOUT = 0, 1, 2, 3, 5, 6, 8
FILTERS, ATTRIBUTE, CONTINUATION, STAB, ATTR_INFO = 11, 12, 16, 17, 21

# h5py's chunk guess (h5py/_hl/filters.py): a chunk of CHUNK_BASE scaled by
# the dataset's size, within [CHUNK_MIN, CHUNK_MAX] bytes
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024

# a variable-length element on disk: its length, the global heap
# collection's address and the object's index in it
VLEN_REF = np.dtype([("len", "<u4"), ("addr", "<u8"), ("idx", "<u4")])

# the fill-value message (version 2) HDF5 writes for h5py's chunked datasets:
# space allocated incrementally, the fill written if set (numbers) or when
# allocated (strings), a fill value defined with size 0 (the default, zeros)
FILL_NUMBER, FILL_STRING = bytes([2, 3, 2, 1, 0, 0, 0, 0]), bytes([2, 3, 0, 1, 0, 0, 0, 0])
HEADER_MIN = 256  # HDF5 gives a new object header this much room, a null message in what is free


class FormatError(OSError):
    """Not an HDF5 file, or an HDF5 feature this codec does not read."""


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


# --------------------------------------------------------------------------
# datatypes and dataspaces
# --------------------------------------------------------------------------


class _Type:
    """A datatype message: its bytes and the numpy dtype its elements read
    as (object for variable-length strings; None for a type this codec does
    not read)."""

    __slots__ = ("raw", "dtype", "vlen_str")

    def __init__(self, raw: bytes):
        self.raw = raw
        cv, b0, _, _, size = struct.unpack_from("<BBBBI", raw, 0)
        cls = cv & 0x0F
        order = ">" if b0 & 1 else "<"
        self.vlen_str, self.dtype = False, None
        if cls == 0 and size in (1, 2, 4, 8):
            self.dtype = np.dtype(f"{order}{'i' if b0 & 0x08 else 'u'}{size}")
        elif cls == 1 and size in (2, 4, 8):
            self.dtype = np.dtype(f"{order}f{size}")
        elif cls == 9 and (b0 & 0x0F) == 1:
            self.dtype, self.vlen_str = np.dtype(object), True

    @property
    def storage(self) -> np.dtype:
        """The dtype of the bytes on disk."""
        return VLEN_REF if self.vlen_str else self.dtype

    def check(self, what: str):
        if self.dtype is None:
            cls = self.raw[0] & 0x0F
            raise FormatError(f"{what}: HDF5 datatype class {cls} is not one this codec reads")


def _type_bytes(dtype) -> bytes:
    """The datatype message for one of the dtypes ``TableStore`` writes, as
    HDF5 encodes them (little-endian), or a variable-length UTF-8 string for
    ``object``."""
    dt = np.dtype(dtype)
    if dt == object:
        # class 9 (variable length), a string of UTF-8, null-padded; its base
        # type is an unsigned byte
        base = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + base
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (4, 8):
        exp, mant, bias = (8, 23, 127) if dt.itemsize == 4 else (11, 52, 1023)
        bits = 8 * dt.itemsize
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, bits - 1, 0, dt.itemsize, 0, bits, mant, exp, 0, mant, bias)
    raise TypeError(f"this codec writes no HDF5 datatype for numpy dtype {dt}")


def _space_bytes(dims: Tuple[int, ...], maxdims: Optional[Tuple[int, ...]] = None) -> bytes:
    """A version-1 dataspace message; rank 0 is a scalar."""
    out = struct.pack("<BBBB4x", 1, len(dims), 1 if maxdims is not None else 0, 0)
    out += struct.pack(f"<{len(dims)}Q", *dims)
    if maxdims is not None:
        out += struct.pack(f"<{len(maxdims)}Q", *maxdims)
    return out


def _parse_space(raw: bytes) -> Tuple[Tuple[int, ...], Optional[Tuple[int, ...]]]:
    version, rank, flags = raw[0], raw[1], raw[2]
    if version != 1:
        raise FormatError(f"dataspace message version {version} is not one this codec reads")
    dims = struct.unpack_from(f"<{rank}Q", raw, 8)
    maxdims = struct.unpack_from(f"<{rank}Q", raw, 8 + 8 * rank) if flags & 1 else None
    return tuple(dims), (tuple(maxdims) if maxdims is not None else None)


# --------------------------------------------------------------------------
# the file
# --------------------------------------------------------------------------


class File:
    """An HDF5 file in this codec's subset. ``mode``: "r" (read only; the
    file must exist), "r+" (read and write; must exist), "a" (read and
    write; created if missing), "w" (created or truncated), "w-" (created;
    must not exist). The root group's ``keys``, ``in``, ``[name]``,
    ``del``, ``create_group`` and ``visit_groups`` are the file's."""

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
        self._f = None
        if mode == "w-" and os.path.exists(path):
            raise FileExistsError(f"unable to create file (file exists): {path}")
        if mode in ("w", "w-"):
            self._f = open(path, "w+b")
            self._sb = bytearray(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                                 + struct.pack("<HHI", GROUP_LEAF_K, GROUP_INTERNAL_K, 0) + b"\0" * 72)
            self._sb_pos = 24
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
        self._f.seek(addr)
        out = self._f.read(n)
        if len(out) != n:
            raise FormatError(f"{self.path}: truncated file: {n} bytes at {addr} run past its end")
        return out

    def _write(self, addr: int, data) -> None:
        self._f.seek(addr)
        self._f.write(data)

    def _alloc(self, n: int) -> int:
        addr = self._eoa
        self._eoa += _pad8(n)
        return addr

    def _append(self, data) -> int:
        """Write ``data`` at the end of the file; its address."""
        addr = self._alloc(len(data))
        self._write(addr, data)
        return addr

    # --- superblock ---
    def _read_superblock(self) -> None:
        head = self._f.read(SUPERBLOCK_SIZE)
        if head[:8] != SIGNATURE:
            raise FormatError(f"{self.path}: not an HDF5 file (no signature at offset 0)")
        version = head[8]
        if version != 0:
            raise FormatError(f"{self.path}: HDF5 superblock version {version} is not one this codec reads "
                              "(it reads and writes version 0, h5py's default)")
        if head[13] != 8 or head[14] != 8:
            raise FormatError(f"{self.path}: {head[13]}-byte addresses and {head[14]}-byte lengths; "
                              "this codec reads 8-byte ones")
        self._leaf_k, self._internal_k = struct.unpack_from("<HH", head, 16)
        self._chunk_k = CHUNK_K
        self._sb_pos = pos = 24
        self._sb = bytearray(head)
        base, _free, eof, access_info = struct.unpack_from("<4Q", head, pos)
        if base != 0 or access_info != UNDEF:
            raise FormatError(f"{self.path}: a user block or a file-access information block; this codec reads "
                              "neither")
        self._eoa = max(_pad8(eof), _pad8(os.path.getsize(self.path)))
        header = struct.unpack_from("<Q", head, pos + 40)[0]
        self.root = _load(self, header)
        if not isinstance(self.root, Group):
            raise FormatError(f"{self.path}: the root object is not a group")

    # --- lifecycle ---
    def flush(self) -> None:
        """Write the metadata that changed, then point the superblock at the
        new root and the new end of the file."""
        if not self.writable or not self.root._flush():
            return
        root, sb, pos = self.root, self._sb, self._sb_pos
        self._f.flush()
        if os.fstat(self._f.fileno()).st_size < self._eoa:
            self._f.truncate(self._eoa)  # HDF5 refuses a file shorter than its end-of-file address
        struct.pack_into("<4Q", sb, pos, 0, UNDEF, self._eoa, UNDEF)
        struct.pack_into("<QQIIQQ", sb, pos + 32, 0, root._addr, 1, 0, root._btree, root._heap)
        self._write(0, bytes(sb))
        self._f.flush()

    def close(self) -> None:
        if self._f is None:
            return
        try:
            self.flush()
        finally:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- the root group's surface ---
    def keys(self) -> List[str]:
        return self.root.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.root

    def __getitem__(self, name: str):
        return self.root[name]

    def __delitem__(self, name: str):
        del self.root[name]

    def create_group(self, name: str) -> "Group":
        return self.root.create_group(name)

    def visit_groups(self) -> Iterator[Tuple[str, "Group"]]:
        return self.root.visit_groups()

    # --- global heap ---
    def _gheap_objects(self, addr: int) -> Dict[int, bytes]:
        """Every object of the collection at ``addr``: index -> bytes."""
        objs = self._gcols.get(addr)
        if objs is not None:
            return objs
        head = self._read(addr, 16)
        if head[:4] != b"GCOL":
            raise FormatError(f"{self.path}: no global heap collection at {addr}")
        size = struct.unpack_from("<Q", head, 8)[0]
        buf = self._read(addr, size)
        objs, pos = {}, 16
        while pos + 16 <= size:
            idx, _nrefs, n = struct.unpack_from("<HH4xQ", buf, pos)
            if idx == 0:  # the free space: the rest of the collection
                break
            objs[idx] = buf[pos + 16:pos + 16 + n]
            pos += 16 + _pad8(n)
        self._gcols[addr] = objs
        return objs

    def _gheap_put(self, blobs: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
        """Store each of ``blobs`` as a global heap object, in this session's
        collections (a new one at the end of the file when the current one is
        full); the (collection address, index) of each."""
        addrs = np.zeros(len(blobs), dtype=np.uint64)
        idxs = np.zeros(len(blobs), dtype=np.uint32)
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
                addrs[i], idxs[i] = col[0], col[3]
                col[2] += need
                col[3] += 1
                i += 1
            # the objects, then the free-space object over the rest
            free = struct.pack("<HH4xQ", 0, 0, col[1] - col[2])
            self._write(col[0] + start, b"".join(parts) + free)
        return addrs, idxs

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
            if k == 0:
                strs[j] = ""
                continue
            blob = self._gheap_objects(k >> 16).get(k & 0xFFFF)
            if blob is None:
                raise FormatError(f"{self.path}: no global heap object {k & 0xFFFF} in the collection at {k >> 16}")
            strs[j] = blob[:n].decode("utf-8")
        out[:] = strs[inverse.ravel()]
        return out

    def _encode_vlen_str(self, values) -> np.ndarray:
        """An array of str (None stands for "") -> variable-length
        references, each distinct string stored once (HDF5 stores each
        element; a reader cannot tell the two apart)."""
        lookup: Dict[str, int] = {}
        inverse = np.fromiter(
            (lookup.setdefault(v if type(v) is str else ("" if v is None else str(v)), len(lookup)) for v in values),
            dtype=np.int64, count=len(values))
        blobs = [u.encode("utf-8") for u in lookup]
        addrs, idxs = self._gheap_put(blobs)  # "" too: HDF5 stores it as an object of 0 bytes
        refs = np.zeros(len(inverse), dtype=VLEN_REF)
        refs["len"] = np.array([len(b) for b in blobs], dtype=np.uint32)[inverse]
        refs["addr"], refs["idx"] = addrs[inverse], idxs[inverse]
        return refs


# --------------------------------------------------------------------------
# object headers
# --------------------------------------------------------------------------


def _read_header(file: File, addr: int) -> List[Tuple[int, int, bytes]]:
    """The messages of the version-1 object header at ``addr``, continuation
    blocks followed, null messages and continuations left out."""
    head = file._read(addr, 16)
    if head[:4] == b"OHDR":
        raise FormatError(f"{file.path}: a version-2 object header at {addr}; this codec reads version 1 "
                          "(HDF5's earliest format)")
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
                blocks.append(struct.unpack_from("<QQ", body, 0))
            elif mtype != NIL:
                msgs.append((mtype, flags, body))
    return msgs


def _header_bytes(msgs: List[Tuple[int, int, bytes]]) -> bytes:
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
    return struct.pack("<BBHII4x", 1, 0, len(parts), 1, len(data)) + data


def _load(file: File, addr: int):
    msgs = _read_header(file, addr)
    types = {m[0] for m in msgs}
    if STAB in types:
        return Group(file, addr, msgs)
    if LAYOUT in types:
        return Dataset(file, addr, msgs)
    if LINK_INFO in types or LINK in types:
        raise FormatError(f"{file.path}: a new-style group (link messages) at {addr}; this codec reads "
                          "symbol-table groups (HDF5's earliest format)")
    return _Object(file, addr, msgs)  # a committed datatype: its attributes read, nothing else


class Attributes:
    """An object's attributes: ``attrs[name]`` (a str for a
    variable-length string, a numpy value otherwise), ``attrs[name] =
    str``, ``in``, ``keys``, ``items``."""

    def __init__(self, obj: "_Object"):
        self._obj = obj

    def keys(self) -> List[str]:
        return list(self._obj._attrs)

    def __contains__(self, name: str) -> bool:
        return name in self._obj._attrs

    def __getitem__(self, name: str):
        return self._obj._attr_value(name)

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __setitem__(self, name: str, value) -> None:
        self._obj._set_attr(name, value)


class _Object:
    """What a group and a dataset share: the header's address, the messages
    kept as they were read, the attributes (raw message bodies, decoded on
    demand) and whether the header must be written anew."""

    def __init__(self, file: File, addr: Optional[int], msgs=()):
        self._file = file
        self._addr = addr
        self._attrs: Dict[str, bytes] = {}
        self._msgs = []
        for mtype, flags, body in msgs:
            if mtype == ATTRIBUTE:
                self._attrs[_attr_name(body)] = body
            elif mtype == ATTR_INFO:
                raise FormatError(f"{file.path}: attributes in dense storage at {addr}; this codec reads them "
                                  "in the object header")
            else:
                self._msgs.append((mtype, flags, body))
        self._dirty = addr is None

    @property
    def attrs(self) -> Attributes:
        return Attributes(self)

    def _attr_value(self, name: str):
        body = self._attrs[name]
        version = body[0]
        name_size, type_size, space_size = struct.unpack_from("<HHH", body, 2)
        if version == 1:
            pos = 8 + _pad8(name_size)
            t = _Type(body[pos:pos + type_size])
            pos += _pad8(type_size)
            dims, _ = _parse_space(body[pos:pos + space_size])
            pos += _pad8(space_size)
        elif version in (2, 3):
            if body[1] & 3:
                raise FormatError(f"{self._file.path}: attribute {name!r} has a shared datatype or dataspace")
            pos = 8 + (1 if version == 3 else 0) + name_size
            t = _Type(body[pos:pos + type_size])
            pos += type_size
            dims, _ = _parse_space(body[pos:pos + space_size])
            pos += space_size
        else:
            raise FormatError(f"{self._file.path}: attribute message version {version}")
        t.check(f"{self._file.path}: attribute {name!r}")
        n = int(np.prod(dims)) if dims else 1
        raw = np.frombuffer(body, dtype=t.storage, count=n, offset=pos)
        vals = self._file._decode_vlen_str(raw) if t.vlen_str else raw.copy()
        if not dims:
            return vals[0]
        return vals.reshape(dims)

    def _set_attr(self, name: str, value) -> None:
        if not isinstance(value, str):
            raise TypeError(f"attribute {name!r}: this codec writes str attributes, got {type(value).__name__}")
        if not self._file.writable:
            raise OSError(f"{self._file.path}: file is read-only")
        ref = self._file._encode_vlen_str([value])
        name_b = name.encode("utf-8") + b"\0"
        dt, sp = _type_bytes(object), _space_bytes(())
        self._attrs[name] = (struct.pack("<BBHHH", 1, 0, len(name_b), len(dt), len(sp))
                             + _padded(name_b) + _padded(dt) + _padded(sp) + ref.tobytes())
        self._dirty = True

    def _header_msgs(self) -> List[Tuple[int, int, bytes]]:
        return list(self._msgs) + [(ATTRIBUTE, 0, body) for body in self._attrs.values()]

    def _flush(self) -> bool:
        """Write this object's header anew if it changed; True when it did
        (its parent must point at the new address)."""
        if not self._dirty:
            return False
        self._addr = self._file._append(_header_bytes(self._header_msgs()))
        self._dirty = False
        return True


def _attr_name(body: bytes) -> str:
    version = body[0]
    name_size = struct.unpack_from("<H", body, 2)[0]
    pos = 9 if version == 3 else 8
    return body[pos:pos + name_size].split(b"\0", 1)[0].decode("utf-8")


# --------------------------------------------------------------------------
# groups
# --------------------------------------------------------------------------


class Group(_Object):
    """A symbol-table group: its links (name -> object header address, read
    when first asked for) and the objects loaded through it."""

    def __init__(self, file: File, addr: Optional[int], msgs=()):
        super().__init__(file, addr, msgs)
        self._btree = self._heap = UNDEF
        for mtype, _, body in self._msgs:
            if mtype == STAB:
                self._btree, self._heap = struct.unpack_from("<QQ", body, 0)
        self._msgs = [m for m in self._msgs if m[0] != STAB]
        self._links: Optional[Dict[str, int]] = None if addr is not None else {}
        self._cache: Dict[str, bytes] = {}  # a symbol-table entry's cache type and scratch pad, as read
        self._objs: Dict[str, _Object] = {}
        self._links_dirty = addr is None

    # --- reading the symbol table ---
    def _read_links(self) -> Dict[str, int]:
        if self._links is not None:
            return self._links
        f = self._file
        head = f._read(self._heap, 32)
        if head[:4] != b"HEAP":
            raise FormatError(f"{f.path}: no local heap at {self._heap}")
        size, _free, data_addr = struct.unpack_from("<QQQ", head, 8)
        heap = f._read(data_addr, size)
        links: Dict[str, int] = {}
        self._walk_btree(self._btree, heap, links)
        self._links = dict(sorted(links.items()))
        return self._links

    def _walk_btree(self, addr: int, heap: bytes, links: Dict[str, int]) -> None:
        f = self._file
        head = f._read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise FormatError(f"{f.path}: no group B-tree node at {addr}")
        level, n = head[5], struct.unpack_from("<H", head, 6)[0]
        body = f._read(addr + 24, 16 * n + 8)
        children = struct.unpack_from(f"<{2 * n + 1}Q", body, 0)[1::2]
        for child in children:
            if level:
                self._walk_btree(child, heap, links)
                continue
            node = f._read(child, 8)
            if node[:4] != b"SNOD":
                raise FormatError(f"{f.path}: no symbol-table node at {child}")
            count = struct.unpack_from("<H", node, 6)[0]
            entries = f._read(child + 8, 40 * count)
            for j in range(count):
                name_off, header = struct.unpack_from("<QQ", entries, 40 * j)
                name = heap[name_off:heap.index(b"\0", name_off)].decode("utf-8")
                links[name] = header
                self._cache[name] = entries[40 * j + 16:40 * j + 40]

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

    def __getitem__(self, name: str):
        head, _, rest = name.strip("/").partition("/")
        links = self._read_links()
        if head not in links:
            raise KeyError(f"{name!r} not in {self._file.path}")
        obj = self._objs.get(head)
        if obj is None:
            obj = self._objs[head] = _load(self._file, links[head])
        return obj[rest] if rest else obj

    def __delitem__(self, name: str) -> None:
        self._check_writable()
        links = self._read_links()
        if name not in links:
            raise KeyError(f"{name!r} not in {self._file.path}")
        del links[name]
        self._objs.pop(name, None)
        self._cache.pop(name, None)
        self._links_dirty = True

    def create_group(self, name: str) -> "Group":
        self._new_name(name)
        return self._add(name, Group(self._file, None))

    def create_dataset(self, name: str, data) -> "Dataset":
        """A chunked, resizable 1-D dataset holding ``data`` (a numpy array
        of a numeric dtype, or of str for variable-length UTF-8 strings);
        its chunks as h5py would choose them for ``data``."""
        self._new_name(name)
        data = np.asarray(data)
        if data.ndim != 1:
            raise ValueError(f"{name!r}: this codec writes 1-D datasets, got shape {data.shape}")
        vlen = data.dtype == object or data.dtype.kind in ("U", "S")
        dtype = np.dtype(object) if vlen else data.dtype.newbyteorder("<")
        ds = Dataset(self._file, None)
        ds._type = _Type(_type_bytes(dtype))
        ds._shape, ds._maxshape = (0,), (UNDEF,)
        ds._chunk = guess_chunk_rows(len(data), 8 if vlen else dtype.itemsize)
        ds._msgs = [(FILL, 1, FILL_STRING if vlen else FILL_NUMBER)]
        ds._chunks = (np.zeros(0, np.uint64), np.zeros(0, np.uint64), np.zeros(0, np.uint32))
        self._add(name, ds)
        ds.append(data)
        return ds

    def visit_groups(self, prefix: str = "") -> Iterator[Tuple[str, "Group"]]:
        """(path, group) for every group below this one, depth first."""
        for name in self.keys():
            obj = self[name]
            if isinstance(obj, Group):
                path = f"{prefix}{name}"
                yield path, obj
                yield from obj.visit_groups(path + "/")

    def _check_writable(self):
        if not self._file.writable:
            raise OSError(f"{self._file.path}: file is read-only")

    def _new_name(self, name: str) -> None:
        self._check_writable()
        if not name or "/" in name or "." == name:
            raise ValueError(f"invalid object name: {name!r}")
        if name in self._read_links():
            raise ValueError(f"unable to create {name!r}: name already exists")

    def _add(self, name: str, obj: _Object) -> _Object:
        self._read_links()[name] = UNDEF
        self._links = dict(sorted(self._links.items()))
        self._objs[name] = obj
        self._links_dirty = True
        return obj

    def _set_attr(self, name: str, value) -> None:
        self._check_writable()
        super()._set_attr(name, value)

    # --- writing ---
    def _flush(self) -> bool:
        """Write what changed below this group, then its symbol table and
        header if they changed."""
        for name, obj in self._objs.items():
            if obj._flush():
                self._links[name] = obj._addr
                self._links_dirty = True
        if self._links_dirty:
            self._write_symbol_table()
            self._links_dirty = False
            self._dirty = True
        return super()._flush()

    def _header_msgs(self):
        return [(STAB, 0, struct.pack("<QQ", self._btree, self._heap))] + super()._header_msgs()

    def _write_symbol_table(self) -> None:
        """A local heap of the names, symbol-table nodes of up to 2 K_leaf
        entries each, and a B-tree over them, all at the end of the file."""
        f = self._file
        names = list(self._links)  # sorted: HDF5 bisects
        heap, offsets = bytearray(8), []  # offset 0 holds the empty string
        for name in names:
            offsets.append(len(heap))
            heap += _padded(name.encode("utf-8") + b"\0")
        heap_addr = f._alloc(32 + len(heap))
        f._write(heap_addr, struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), 1, heap_addr + 32) + bytes(heap))
        cap = 2 * f._leaf_k
        snod_size = 8 + 40 * cap
        groups = [list(range(i, min(i + cap, len(names)))) for i in range(0, len(names), cap)]
        snod_addrs = []
        for members in groups:
            node = bytearray(snod_size)
            struct.pack_into("<4sBxH", node, 0, b"SNOD", 1, len(members))
            for j, k in enumerate(members):
                obj = self._objs.get(names[k])
                if isinstance(obj, Group):  # a group's entry caches its symbol table, as HDF5's do
                    cache = struct.pack("<IIQQ", 1, 0, obj._btree, obj._heap)
                elif obj is None and names[k] in self._cache:
                    cache = self._cache[names[k]]
                else:
                    cache = bytes(24)
                node[8 + 40 * j:48 + 40 * j] = struct.pack("<QQ", offsets[k], self._links[names[k]]) + cache
            snod_addrs.append(f._append(bytes(node)))
        # the keys: heap offsets of the empty string, then of each node's last name
        left = [0] + [offsets[m[-1]] for m in groups[:-1]]
        right = [offsets[m[-1]] for m in groups]
        self._btree = _write_btree(f, 0, f._internal_k, snod_addrs, left, right, lambda off: struct.pack("<Q", off),
                                   empty_key=struct.pack("<Q", 0))
        self._heap = heap_addr


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
# datasets
# --------------------------------------------------------------------------


class Dataset(_Object):
    """A 1-D chunked dataset, read whole and appended to."""

    def __init__(self, file: File, addr: Optional[int], msgs=()):
        super().__init__(file, addr, msgs)
        self._unreadable = None  # why read and append refuse this dataset, if they do
        self._chunks = None  # (offsets, addresses, sizes), read when first needed
        self._chunks_dirty = False
        self._type_flags = 1  # the datatype message is constant
        self._filtered = False
        self._index = UNDEF
        if addr is None:
            return
        for mtype, flags, body in self._msgs:
            if mtype == DATASPACE:
                self._shape, self._maxshape = _parse_space(body)
            elif mtype == DATATYPE:
                self._type, self._type_flags = _Type(body), flags
                if flags & 2:
                    self._unreadable = f"{file.path}: the dataset at {addr} has a committed (shared) datatype"
            elif mtype == FILTERS:
                self._filtered = True
            elif mtype == LAYOUT:
                self._parse_layout(body)
        self._msgs = [m for m in self._msgs if m[0] not in (DATASPACE, DATATYPE, LAYOUT)]
        if self._unreadable is None and self._filtered:
            self._unreadable = (f"{file.path}: the dataset at {addr} has filters (compression); this codec reads "
                                "and writes unfiltered data")

    def _parse_layout(self, body: bytes) -> None:
        """Version 3 of the layout message, 1-D chunked; anything else is
        noted, and refused when the data is read or written."""
        version, cls = body[0], body[1]
        if version == 3 and cls == 2 and body[2] == 2:
            self._index = struct.unpack_from("<Q", body, 3)[0]
            self._chunk = struct.unpack_from("<I", body, 11)[0]
        else:
            self._unreadable = (f"{self._file.path}: the dataset at {self._addr} has a layout message of version "
                                f"{version}, class {cls}; this codec reads 1-D chunked datasets (version 3, class 2)")

    def _set_attr(self, name: str, value) -> None:
        if self._unreadable:
            raise FormatError(self._unreadable)
        super()._set_attr(name, value)

    # --- the surface ---
    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        if self._unreadable:
            raise FormatError(self._unreadable)
        self._type.check(f"{self._file.path}: dataset at {self._addr}")
        return self._type.dtype

    @property
    def chunks(self) -> Tuple[int]:
        return (self._chunk,)

    def read(self) -> np.ndarray:
        """The whole dataset."""
        t = self._type
        t.check(f"{self._file.path}: dataset at {self._addr}")
        if self._unreadable:
            raise FormatError(self._unreadable)
        f = self._file
        n = self._shape[0]
        raw = np.zeros(n, dtype=t.storage)  # the fill value where no chunk was written
        offsets, addrs, _ = self._chunk_index()
        esize, c = t.storage.itemsize, self._chunk
        # runs of chunks that lie end to end in the file are read at once
        keep = offsets < n
        offsets, addrs = offsets[keep].astype(np.int64), addrs[keep].astype(np.int64)
        if len(offsets):
            brk = np.flatnonzero((np.diff(addrs) != c * esize) | (np.diff(offsets) != c)) + 1
            for s, e in zip(np.r_[0, brk], np.r_[brk, len(offsets)]):
                lo = int(offsets[s])
                hi = min(int(offsets[e - 1]) + c, n)
                raw[lo:hi] = np.frombuffer(f._read(int(addrs[s]), (hi - lo) * esize), dtype=t.storage)
        return f._decode_vlen_str(raw) if t.vlen_str else raw

    def append(self, data) -> None:
        """Add ``data``'s rows at the end: the last chunk's free rows are
        filled in place, the rest go into new chunks, end to end at the end of
        the file."""
        f = self._file
        if not f.writable:
            raise OSError(f"{f.path}: file is read-only")
        if self._unreadable:
            raise FormatError(self._unreadable)
        if self._maxshape is None or self._maxshape[0] != UNDEF:
            raise OSError(f"{f.path}: the dataset at {self._addr} is not resizable")
        t = self._type
        t.check(f"{f.path}: dataset at {self._addr}")
        data = np.asarray(data)
        if t.vlen_str:
            raw = f._encode_vlen_str(data)
        else:
            raw = np.ascontiguousarray(data, dtype=t.dtype)
        if raw.ndim != 1:
            raise ValueError(f"append: 1-D data expected, got shape {raw.shape}")
        offsets, addrs, sizes = self._chunk_index()
        n_old, c, esize = self._shape[0], self._chunk, t.storage.itemsize
        used = n_old % c
        if used and len(raw):
            last = n_old - used
            hit = np.flatnonzero(offsets == last)
            k = min(c - used, len(raw))
            if len(hit):
                f._write(int(addrs[hit[0]]) + used * esize, raw[:k].tobytes())
            else:  # a chunk never written: write it whole
                chunk = np.zeros(c, dtype=t.storage)
                chunk[used:used + k] = raw[:k]
                offsets, addrs, sizes = (np.r_[offsets, last].astype(np.uint64),
                                         np.r_[addrs, f._append(chunk.tobytes())].astype(np.uint64),
                                         np.r_[sizes, c * esize].astype(np.uint32))
            raw = raw[k:]
            n_done = n_old + k
        else:
            n_done = n_old
        if len(raw):
            count = -(-len(raw) // c)
            buf = np.zeros(count * c, dtype=t.storage)
            buf[:len(raw)] = raw
            base = f._append(buf.tobytes())
            offsets = np.r_[offsets, n_done + c * np.arange(count)].astype(np.uint64)
            addrs = np.r_[addrs, base + c * esize * np.arange(count)].astype(np.uint64)
            sizes = np.r_[sizes, np.full(count, c * esize)].astype(np.uint32)
        self._chunks = (offsets, addrs, sizes)
        self._shape = (n_done + len(raw),)
        self._chunks_dirty = self._dirty = True

    # --- the chunk index ---
    def _chunk_index(self):
        if self._chunks is None:
            found = []
            if self._index != UNDEF:
                self._walk_chunks(self._index, found)
            arr = np.array(found, dtype=np.uint64).reshape(-1, 3)
            order = np.argsort(arr[:, 0], kind="stable")
            arr = arr[order]
            self._chunks = (arr[:, 0].copy(), arr[:, 1].copy(), arr[:, 2].astype(np.uint32))
        return self._chunks

    def _walk_chunks(self, addr: int, found: list) -> None:
        f = self._file
        head = f._read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise FormatError(f"{f.path}: no chunk B-tree node at {addr}")
        level, n = head[5], struct.unpack_from("<H", head, 6)[0]
        entry = np.dtype([("size", "<u4"), ("mask", "<u4"), ("offset", "<u8"), ("elem", "<u8"), ("child", "<u8")])
        rows = np.frombuffer(f._read(addr + 24, 32 * n), dtype=entry, count=n)
        if level:
            for child in rows["child"].tolist():
                self._walk_chunks(child, found)
            return
        if np.any(rows["mask"] != 0):
            raise FormatError(f"{f.path}: a chunk with a filter mask at {addr}")
        found.extend(zip(rows["offset"].tolist(), rows["child"].tolist(), rows["size"].tolist()))

    # --- writing ---
    def _flush(self) -> bool:
        if self._chunks_dirty:
            self._write_chunk_btree()
            self._chunks_dirty = False
        return super()._flush()

    def _header_msgs(self):
        msgs = [(DATASPACE, 0, _space_bytes(self._shape, self._maxshape)), (DATATYPE, self._type_flags, self._type.raw)]
        msgs += list(self._msgs)
        esize = self._type.storage.itemsize
        msgs.append((LAYOUT, 0, struct.pack("<BBBQII", 3, 2, 2, self._index, self._chunk, esize)))
        return msgs + [(ATTRIBUTE, 0, body) for body in self._attrs.values()]

    def _write_chunk_btree(self) -> None:
        offsets, addrs, sizes = self._chunks
        if not len(offsets):
            self._index = UNDEF
            return
        # a key: the chunk's byte size, its filter mask, its offset and the
        # offset in the element's bytes, 0. A chunk's right key is the next
        # chunk's key; the last one's, as HDF5 makes it, is one chunk further
        # on in every dimension: its offset plus a chunk, and the element size
        lefts = [(size, off, 0) for size, off in zip(sizes.tolist(), offsets.tolist())]
        rights = lefts[1:] + [(0, int(offsets[-1]) + self._chunk, self._type.storage.itemsize)]
        self._index = _write_btree(self._file, 1, self._file._chunk_k, addrs.tolist(), lefts, rights,
                                   lambda key: struct.pack("<IIQQ", key[0], 0, key[1], key[2]),
                                   empty_key=b"\0" * 24)
