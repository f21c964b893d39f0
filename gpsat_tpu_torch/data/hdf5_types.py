"""HDF5 datatype and dataspace messages for the port's codec (``data/hdf5.py``).

Section numbers are those of the HDF5 File Format Specification version
3.0 (IV.A.2.b the dataspace message, IV.A.2.d the datatype message). Each
datatype maps to the numpy dtype h5py gives for it:

- fixed-point (class 0) and bitfield (4): ``[<>][iu]{1,2,4,8}``;
- floating point (1): ``[<>]f{2,4,8}``;
- fixed-length strings (3): ``S{n}``; a value stops at its first null
  (null-terminated and null-padded) or loses its trailing spaces
  (space-padded), as HDF5's conversion to h5py's memory type leaves it;
- opaque (5): ``V{n}``;
- compound (6): a structured dtype with the members' names, offsets and
  the type's size, members nested and with subarray shapes;
- object references (7, type 0): ``<u8``, the object header's address
  (stored in the file's size of offsets); region references (7, type 1):
  ``object``, each a ``RegionReference`` (``data/hdf5_selections.py``) once
  the codec has read its global heap object;
- enums (8): the base integer dtype, with h5py's ``enum`` metadata; an
  enum of exactly FALSE = 0 and TRUE = 1 is ``bool`` (h5py's rule);
- variable-length strings and sequences (9): ``object`` (``str``; an
  array of the base type);
- arrays (10): a subarray dtype.

A datatype the codec does not read (time, VAX floats, version-4 references,
a variable-length member or a region reference inside a compound or an
array) is still parsed, so its object is listed; reading its values raises
``FormatError`` naming it. Addresses and lengths are as wide as the file's
superblock says (``uint``); a type's own size says how wide its references
are.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

UNDEF = 0xFFFF_FFFF_FFFF_FFFF  # the undefined address, and H5S_UNLIMITED


def vlen_ref(size: int) -> np.dtype:
    """A variable-length element on disk, ``size`` bytes: its length, the
    global heap collection's address (the file's size of offsets) and the
    object's index in it (IV.A.2.d, class 9)."""
    return np.dtype([("len", "<u4"), ("addr", f"<u{size - 8}"), ("idx", "<u4")])


VLEN_REF = vlen_ref(16)  # with 8-byte addresses, the only ones this codec writes

# string padding (class 3 bit field bits 0-3)
NULLTERM, NULLPAD, SPACEPAD = 0, 1, 2


class FormatError(OSError):
    """Not an HDF5 file, or an HDF5 feature this codec does not read."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def uint(buf: bytes, pos: int, width: int) -> int:
    """The little-endian unsigned integer of ``width`` bytes at ``pos``: an
    address or a length in the file's sizes. All ones, HDF5's undefined
    address and H5S_UNLIMITED at any width, reads as UNDEF."""
    v = int.from_bytes(buf[pos:pos + width], "little")
    return UNDEF if v == (1 << 8 * width) - 1 else v


def limit_enc_size(n: int) -> int:
    """Bytes HDF5 takes to encode values up to ``n`` (``H5VM_limit_enc_size``)."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


def _cstring(raw: bytes, pos: int, padded: bool) -> Tuple[str, int]:
    """A null-terminated name at ``pos``, and the position after it (after its
    padding to a multiple of 8 when ``padded``)."""
    end = raw.index(b"\0", pos)
    name = raw[pos:end].decode("utf-8")
    n = end + 1 - pos
    return name, pos + (_pad8(n) if padded else n)


class Type:
    """A parsed datatype message: its bytes, its class, the numpy dtype its
    values read as (``dtype``) and the dtype of its bytes on disk
    (``storage``). ``vlen`` is "str", "seq" or None; ``base`` the element
    type of a sequence; ``strpad`` the padding of a fixed-length string;
    ``region`` whether it is a region reference; ``unreadable`` why its
    values cannot be read, or None."""

    __slots__ = ("raw", "cls", "dtype", "storage", "vlen", "base", "strpad", "unreadable", "members", "region")

    def __init__(self, raw: bytes, cls: int):
        self.raw, self.cls = raw, cls
        self.dtype = self.storage = None
        self.vlen = self.base = self.strpad = self.unreadable = None
        self.region = False
        self.members = None  # a compound's [(name, offset, Type)], or an array's base as [(None, 0, Type)]

    @property
    def vlen_str(self) -> bool:
        return self.vlen == "str"

    def check(self, what: str):
        if self.unreadable:
            raise FormatError(f"{what}: {self.unreadable}")

    def has_strings(self) -> bool:
        """Whether a fixed-length string lies anywhere in the type."""
        if self.cls == 3:
            return True
        return any(t.has_strings() for _, _, t in (self.members or ()))


def parse_type(raw: bytes, pos: int = 0) -> Tuple[Type, int]:
    """The datatype message at ``raw[pos:]`` and the position after it."""
    cv, b0, b1, b2, size = struct.unpack_from("<BBBBI", raw, pos)
    cls, version = cv & 0x0F, cv >> 4
    start, pos = pos, pos + 8
    t = Type(b"", cls)
    order = ">" if b0 & 1 else "<"
    if cls in (0, 4):  # fixed-point, bitfield: bit offset and precision
        pos += 4
        if size in (1, 2, 4, 8):
            kind = "i" if (cls == 0 and b0 & 0x08) else "u"
            t.dtype = np.dtype(f"{order}{kind}{size}")
        else:
            t.unreadable = f"a {size}-byte {'integer' if cls == 0 else 'bitfield'} type"
    elif cls == 1:  # floating point: 12 bytes of properties
        pos += 12
        if b0 & 0x40:
            t.unreadable = "a VAX-order floating-point type"
        elif size in (2, 4, 8):
            t.dtype = np.dtype(f"{order}f{size}")
        else:
            t.unreadable = f"a {size}-byte floating-point type"
    elif cls == 2:
        pos += 2
        t.unreadable = "HDF5 datatype class 2 (time)"
    elif cls == 3:
        t.dtype, t.strpad = np.dtype(f"S{size}"), b0 & 0x0F
    elif cls == 5:  # opaque: an ASCII tag padded to 8
        pos += _pad8(b0) if b0 else 0
        t.dtype = np.dtype(f"V{size}")
    elif cls == 6:
        pos = _parse_compound(t, raw, pos, version, b0 | (b1 << 8), size)
    elif cls == 7:  # an address of the file's size of offsets; a region's, a global heap ID
        if version >= 4 or (b0 & 0x0F) > 1:
            t.unreadable = f"a reference of type {b0 & 0x0F}, datatype version {version}" + (
                " (HDF5 1.12's H5R_REF)" if version >= 4 else "")
        elif b0 & 0x0F:
            t.region, t.dtype = True, np.dtype(object)
            t.storage = np.dtype([("addr", f"<u{size - 4}"), ("idx", "<u4")])
        else:
            t.dtype, t.storage = np.dtype("<u8"), np.dtype(f"<u{size}")
    elif cls == 8:
        pos = _parse_enum(t, raw, pos, version, b0 | (b1 << 8))
    elif cls == 9:
        base, pos = parse_type(raw, pos)
        t.base, t.storage, t.dtype = base, vlen_ref(size), np.dtype(object)
        t.vlen = "str" if (b0 & 0x0F) == 1 else "seq"
        if t.vlen == "seq" and base.unreadable:
            t.unreadable = base.unreadable
        elif t.vlen == "seq" and (base.vlen or base.region or base.dtype is None):
            t.unreadable = "a variable-length sequence of variable-length elements or region references"
    elif cls == 10:
        ndims = raw[pos]
        if version < 3:  # dims, then a permutation index for each, after 3 reserved bytes
            dims = struct.unpack_from(f"<{ndims}I", raw, pos + 4)
            pos += 4 + 8 * ndims
        else:
            dims = struct.unpack_from(f"<{ndims}I", raw, pos + 1)
            pos += 1 + 4 * ndims
        base, pos = parse_type(raw, pos)
        t.members = [(None, 0, base)]
        if base.unreadable or base.vlen or base.region:
            t.unreadable = base.unreadable or "an array of variable-length elements or region references"
        else:
            t.dtype = np.dtype((base.dtype, tuple(dims)))
            t.storage = np.dtype((base.storage, tuple(dims)))
    else:
        t.unreadable = f"HDF5 datatype class {cls}"
    if t.storage is None and t.dtype is not None:
        t.storage = t.dtype
    t.raw = bytes(raw[start:pos])
    return t, pos


def _parse_compound(t: Type, raw: bytes, pos: int, version: int, n: int, size: int) -> int:
    names, formats, storage, offsets, members = [], [], [], [], []
    off_size = limit_enc_size(size)
    for _ in range(n):
        name, pos = _cstring(raw, pos, padded=version < 3)
        if version < 3:
            offset = struct.unpack_from("<I", raw, pos)[0]
            pos += 4
        else:
            offset = int.from_bytes(raw[pos:pos + off_size], "little")
            pos += off_size
        dims = ()
        if version == 1:  # dimensionality, reserved, permutation, reserved, four dimension sizes
            ndims = raw[pos]
            dims = struct.unpack_from("<4I", raw, pos + 12)[:ndims]
            pos += 28
        mt, pos = parse_type(raw, pos)
        members.append((name, offset, mt))
        if mt.unreadable or mt.vlen or mt.region:
            t.unreadable = mt.unreadable or f"a variable-length or region-reference member {name!r} in a compound"
            continue
        names.append(name)
        offsets.append(offset)
        member = mt.storage if mt.cls == 7 else mt.dtype  # a reference member keeps its width
        formats.append(np.dtype((member, dims)) if dims else member)
        storage.append(np.dtype((mt.storage, dims)) if dims else mt.storage)
    t.members = members
    if not t.unreadable:
        t.dtype = np.dtype({"names": names, "formats": formats, "offsets": offsets, "itemsize": size})
        t.storage = np.dtype({"names": names, "formats": storage, "offsets": offsets, "itemsize": size})
    return pos


def _parse_enum(t: Type, raw: bytes, pos: int, version: int, n: int) -> int:
    base, pos = parse_type(raw, pos)
    names = []
    for _ in range(n):
        name, pos = _cstring(raw, pos, padded=version < 3)
        names.append(name)
    bsize = base.dtype.itemsize if base.dtype is not None else 0
    values = np.frombuffer(raw, dtype=base.dtype, count=n, offset=pos).tolist() if bsize else []
    pos += bsize * n
    t.base = base
    if base.dtype is None or base.dtype.kind not in "iu":
        t.unreadable = base.unreadable or "an enum over a non-integer type"
        return pos
    members = dict(zip(names, values))
    if members == {"FALSE": 0, "TRUE": 1}:
        t.dtype = np.dtype(bool)
        # stored as its base integer; one byte of 0 or 1 reads as bool directly
        t.storage = np.dtype(bool) if bsize == 1 else base.dtype
    else:
        t.dtype = np.dtype(base.dtype.str, metadata={"enum": members})
        t.storage = base.dtype
    return pos


def fix_strings(arr: np.ndarray, t: Type) -> np.ndarray:
    """Fixed-length strings as HDF5 converts them to h5py's memory type
    (null-padded): a null-terminated or null-padded value stops at its
    first null, a space-padded one loses its trailing spaces. Works on
    compound members too. ``arr`` must be writable; the result may be
    ``arr`` itself."""
    if not t.has_strings() or arr.size == 0:
        return arr
    if t.cls == 3:
        if not arr.flags.c_contiguous:
            arr = arr.copy()
        b = arr.reshape(-1).view(np.uint8).reshape(arr.size, t.dtype.itemsize)
        if t.strpad == SPACEPAD:
            b[np.cumprod((b == 0x20)[:, ::-1], axis=1)[:, ::-1].astype(bool)] = 0
        else:
            b[np.cumsum(b == 0, axis=1) > 0] = 0
        return arr
    if t.cls == 6:
        for name, _, mt in t.members:
            if mt.has_strings():
                arr[name] = fix_strings(arr[name], mt)
        return arr
    return fix_strings(arr, t.members[0][2])  # an array type: numpy has expanded its dims


def type_bytes(dtype) -> bytes:
    """The datatype message (IV.A.2.d, version 1) that h5py writes for a
    numpy dtype: little-endian numbers, ``bool`` as an enum of FALSE and
    TRUE over a signed byte, ``S{n}`` as a null-padded ASCII string,
    ``object`` as a variable-length UTF-8 string."""
    dt = np.dtype(dtype)
    if dt == object:
        # class 9 (variable length), a string of UTF-8, null-padded; its base
        # type is an unsigned byte
        base = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + base
    if dt.kind == "b":
        base = struct.pack("<BBBBIHH", 0x10, 0x08, 0, 0, 1, 0, 8)
        names = b"FALSE\0\0\0" + b"TRUE\0\0\0\0"
        return struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + names + bytes([0, 1])
    if dt.kind == "S":
        return struct.pack("<BBBBI", 0x13, NULLPAD, 0, 0, dt.itemsize)
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (2, 4, 8):
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[dt.itemsize]
        bits = 8 * dt.itemsize
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, bits - 1, 0, dt.itemsize, 0, bits, mant, exp, 0, mant, bias)
    raise TypeError(f"this codec writes no HDF5 datatype for numpy dtype {dt}")


def string_type_bytes(n: int) -> bytes:
    """A fixed-length ASCII string of ``n`` bytes, null-terminated: the type
    HDF5's dimension-scale functions give ``CLASS`` and ``NAME``."""
    return struct.pack("<BBBBI", 0x13, NULLTERM, 0, 0, n)


# an object reference (class 7, type 0), 8 bytes
OBJ_REF_TYPE = struct.pack("<BBBBI", 0x17, 0, 0, 0, 8)


def vlen_seq_type_bytes(base: bytes) -> bytes:
    """A variable-length sequence of ``base`` (class 9, type 0)."""
    return struct.pack("<BBBBI", 0x19, 0, 0, 0, 16) + base


def compound_type_bytes(members, size: int) -> bytes:
    """A version-1 compound of scalar ``members`` [(name, offset, type
    bytes)] and ``size`` bytes."""
    out = struct.pack("<BBBBI", 0x16, len(members) & 0xFF, len(members) >> 8, 0, size)
    for name, offset, tb in members:
        nb = name.encode("utf-8") + b"\0"
        out += nb + b"\0" * (_pad8(len(nb)) - len(nb)) + struct.pack("<IB3xI4x4I", offset, 0, 0, 0, 0, 0, 0) + tb
    return out


# --------------------------------------------------------------------------
# dataspaces (IV.A.2.b)
# --------------------------------------------------------------------------


def space_bytes(dims: Tuple[int, ...], maxdims: Optional[Tuple[int, ...]] = None) -> bytes:
    """A version-1 dataspace message; rank 0 is a scalar."""
    out = struct.pack("<BBBB4x", 1, len(dims), 1 if maxdims is not None else 0, 0)
    out += struct.pack(f"<{len(dims)}Q", *dims)
    if maxdims is not None:
        out += struct.pack(f"<{len(maxdims)}Q", *maxdims)
    return out


def parse_space(raw: bytes, sl: int = 8) -> Tuple[Optional[Tuple[int, ...]], Optional[Tuple[int, ...]]]:
    """(dims, maxdims) of a dataspace message of version 1 or 2, each size
    ``sl`` bytes (the file's size of lengths): dims () for a scalar and None
    for a null dataspace, maxdims None when not stored, an unlimited one
    UNDEF."""
    version, rank, flags = raw[0], raw[1], raw[2]
    if version == 1:
        pos, kind = 8, 1 if rank else 0
    elif version == 2:
        pos, kind = 4, raw[3]
    else:
        raise FormatError(f"dataspace message version {version} is not one this codec reads")
    if kind == 2:
        return None, None
    dims = tuple(uint(raw, pos + sl * i, sl) for i in range(rank))
    maxdims = tuple(uint(raw, pos + sl * (rank + i), sl) for i in range(rank)) if flags & 1 else None
    return dims, maxdims
