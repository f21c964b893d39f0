"""HDF5's later on-disk structures for the port's codec (``data/hdf5.py``):
the metadata checksum, the filter pipeline (both ways), fractal heaps, version-2
B-trees and the chunk indexes of version-4 layouts (fixed and extensible
arrays, B-trees of chunk records). Section numbers are those of the HDF5
File Format Specification version 3.0. Each reader takes ``read(addr, n)
-> bytes``, the file's path (for messages) and the file's sizes of offsets
and lengths (``so``, ``sl``: 8 or 4 bytes, as the superblock gives
them); every signature and checksum is checked.
"""

from __future__ import annotations

import bz2
import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from gpsat_tpu_torch.data.hdf5_types import UNDEF, FormatError, limit_enc_size, uint

_M = 0xFFFF_FFFF
Reader = Callable[[int, int], bytes]


# --------------------------------------------------------------------------
# checksums (III.F: Jenkins' lookup3 "hashlittle", as H5_checksum_lookup3)
# --------------------------------------------------------------------------


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 hash of ``data``: the checksum of every
    version-2 structure (superblock, object headers, B-tree nodes, heap
    blocks, chunk index arrays). The plain version of the host library's
    loop, which ``checksum`` runs."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M
    if n == 0:
        return c
    full = (n - 1) // 12  # the blocks mixed before the last one
    words = struct.unpack_from(f"<{3 * full}I", data, 0)
    for i in range(0, 3 * full, 3):
        a, b, c = (a + words[i]) & _M, (b + words[i + 1]) & _M, (c + words[i + 2]) & _M
        a = (a - c) & _M; a ^= _rot(c, 4); c = (c + b) & _M  # noqa: E702
        b = (b - a) & _M; b ^= _rot(a, 6); a = (a + c) & _M  # noqa: E702
        c = (c - b) & _M; c ^= _rot(b, 8); b = (b + a) & _M  # noqa: E702
        a = (a - c) & _M; a ^= _rot(c, 16); c = (c + b) & _M  # noqa: E702
        b = (b - a) & _M; b ^= _rot(a, 19); a = (a + c) & _M  # noqa: E702
        c = (c - b) & _M; c ^= _rot(b, 4); b = (b + a) & _M  # noqa: E702
    # the last 1-12 bytes, added as if zero-padded to 12
    ta, tb, tc = struct.unpack("<3I", data[12 * full:].ljust(12, b"\0"))
    a, b, c = (a + ta) & _M, (b + tb) & _M, (c + tc) & _M
    c ^= b; c = (c - _rot(b, 14)) & _M  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & _M  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & _M  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & _M  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & _M  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & _M  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & _M  # noqa: E702
    return c


def checksum(data: bytes) -> int:
    """lookup3 of ``data`` in the C++ host library (built at first use; a
    failed build raises)."""
    from gpsat_tpu_torch import native

    return native.lookup3(data)


def check_sum(buf: bytes, path: str, what: str) -> None:
    """``buf``'s last four bytes are the lookup3 checksum of the rest."""
    stored = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    if checksum(buf[:-4]) != stored:
        raise FormatError(f"{path}: the checksum of {what} does not match")


def _checked(read: Reader, addr: int, n: int, sig: bytes, path: str, what: str) -> bytes:
    """The ``n`` bytes of the structure at ``addr``: its signature and its
    checksum (the last four bytes) checked."""
    buf = read(addr, n)
    if sig and buf[:4] != sig:
        raise FormatError(f"{path}: no {what} at {addr}")
    check_sum(buf, path, f"the {what} at {addr}")
    return buf


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): big-endian 16-bit
    words, sums folded every 360 words, an odd last byte as the high byte
    of a word, and a last fold to 16 bits."""
    n = len(data) // 2
    w = np.frombuffer(data, dtype=">u2", count=n).astype(np.int64)
    s1 = s2 = 0
    for lo in range(0, n, 360):
        blk = w[lo:lo + 360]
        t = len(blk)
        # within a block: sum1 += w, sum2 += sum1 after each word
        s2 = (s2 + t * s1 + int(np.sum(np.cumsum(blk)))) & _M  # uint32 sums, as in HDF5
        s1 = (s1 + int(blk.sum())) & _M
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & _M


# --------------------------------------------------------------------------
# the filter pipeline (IV.A.2.l) and the filters this codec applies
# --------------------------------------------------------------------------

DEFLATE, SHUFFLE, FLETCHER32, BZIP2, LZF, BLOSC = 1, 2, 3, 307, 32000, 32001
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                305: "lzo", 307: "bzip2", 32000: "lzf", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                32015: "zstd"}


class Filter:
    """One filter of a pipeline: its id, flags (bit 0: optional), name and
    client data."""

    __slots__ = ("id", "flags", "name", "client")

    def __init__(self, fid: int, flags: int, name: str, client: Tuple[int, ...]):
        self.id, self.flags, self.name, self.client = fid, flags, name, client

    def label(self) -> str:
        name = self.name or FILTER_NAMES.get(self.id, "unregistered")
        return f"filter {self.id} ({name})"


def parse_filters(body: bytes) -> List[Filter]:
    """The filter pipeline message, versions 1 and 2, in pipeline order."""
    version, n = body[0], body[1]
    if version not in (1, 2):
        raise FormatError(f"filter pipeline message version {version} is not one this codec reads")
    pos, out = (8 if version == 1 else 2), []
    for _ in range(n):
        fid = struct.unpack_from("<H", body, pos)[0]
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", body, pos)[0]
            pos += 2
        flags, ncv = struct.unpack_from("<HH", body, pos)
        pos += 4
        name = body[pos:pos + name_len].split(b"\0", 1)[0].decode("ascii", "replace")
        pos += name_len
        client = struct.unpack_from(f"<{ncv}I", body, pos)
        pos += 4 * ncv + (4 if version == 1 and ncv % 2 else 0)
        out.append(Filter(fid, flags, name, client))
    return out


def check_filters(filters: List[Filter]) -> Optional[str]:
    """Why chunks through ``filters`` cannot be read (a mandatory filter this
    codec does not apply), or None. An optional one fails only on a chunk
    that went through it (its filter-mask bit clear)."""
    for flt in filters:
        if flt.id not in (DEFLATE, SHUFFLE, FLETCHER32, BZIP2, LZF, BLOSC) and not flt.flags & 1:
            return f"{flt.label()} is not one this codec applies (it applies deflate, shuffle, fletcher32, " \
                   "lzf, blosc and bzip2)"
    return None


def unfilter(data: bytes, filters: List[Filter], mask: int, itemsize: int, where: str, chunk_bytes: int) -> bytes:
    """Undo ``filters`` on one chunk of ``chunk_bytes`` bytes, last first,
    skipping each filter whose bit is set in the chunk's filter ``mask``."""
    for i in range(len(filters) - 1, -1, -1):
        if mask >> i & 1:
            continue
        flt = filters[i]
        if flt.id == DEFLATE:
            data = zlib.decompress(data)
        elif flt.id == SHUFFLE:
            size = flt.client[0] if flt.client else itemsize
            n = len(data) // size
            if size > 1 and n > 1:
                head = np.frombuffer(data, dtype=np.uint8, count=n * size).reshape(size, n).T
                data = head.tobytes() + data[n * size:]
        elif flt.id == FLETCHER32:
            if len(data) < 4:
                raise FormatError(f"{where}: a fletcher32 chunk of {len(data)} bytes")
            body, stored = data[:-4], struct.unpack("<I", data[-4:])[0]
            want = fletcher32(body)
            # HDF5 before 1.6.3 stored it with its 16-bit halves' bytes swapped; HDF5 accepts both
            swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
            if stored not in (want, swapped):
                raise FormatError(f"{where}: fletcher32 checksum mismatch (stored {stored:#010x}, "
                                  f"computed {want:#010x})")
            data = body
        elif flt.id == BZIP2:
            data = bz2.decompress(data)
        elif flt.id == LZF:
            from gpsat_tpu_torch.data.lzf import lzf_decode

            # h5py's filter keeps the chunk's bytes in its third client value
            n = flt.client[2] if len(flt.client) > 2 and flt.client[2] else chunk_bytes
            try:
                data = lzf_decode(data, n)
            except ValueError as e:
                raise FormatError(f"{where}: {e}") from None
        elif flt.id == BLOSC:
            from gpsat_tpu_torch.data.blosc import blosc_decode

            data = blosc_decode(data)
        else:
            raise FormatError(f"{where}: {flt.label()} is not one this codec applies")
    return data


# the blosc filter's compressor codes (hdf5-blosc's client value 6) that
# data/blosc.py encodes, by its names; lz4hc writes lz4 streams
BLOSC_ENCODERS = {1: "lz4", 2: "lz4", 4: "zlib", 5: "zstd"}


def unencodable(filters: List[Filter]) -> Optional[str]:
    """Why a chunk cannot be sent through ``filters`` (a filter this codec
    has no encoder for), or None."""
    for flt in filters:
        if flt.id not in (DEFLATE, SHUFFLE, FLETCHER32, BZIP2, LZF, BLOSC):
            return f"{flt.label()} has no encoder in this codec (it encodes deflate, shuffle, fletcher32, " \
                   "bzip2, lzf and blosc)"
        if flt.id in (DEFLATE, SHUFFLE) and not flt.client and not flt.flags & 1:
            return f"{flt.label()} is mandatory and has no client data, without which HDF5's filter fails"
        if flt.id == BLOSC:
            code = flt.client[6] if len(flt.client) > 6 else 0
            if code not in BLOSC_ENCODERS:
                return f"{flt.label()} with compressor code {code}: this codec's blosc encoder writes lz4, " \
                       "zlib and zstd"
            if BLOSC_ENCODERS[code] == "zstd":
                import importlib.util

                if importlib.util.find_spec("zstandard") is None:
                    return f"{flt.label()} with zstd: the zstandard module is not installed"
    return None


def _lzf_literals(data: bytes) -> bytes:
    """An lzf stream of literal runs only (a control byte of the run's
    length less one before each run of at most 32 bytes): what lzf_decode
    and h5py's lzf filter read, never shorter than the data."""
    n = len(data)
    if not n:
        return b""
    runs = -(-n // 32)
    body = np.zeros(runs * 32, np.uint8)
    body[:n] = np.frombuffer(data, np.uint8)
    last = n - 32 * (runs - 1)
    control = np.full((runs, 1), 31, np.uint8)
    control[-1] = last - 1
    return np.hstack([control, body.reshape(runs, 32)]).reshape(-1)[:33 * (runs - 1) + 1 + last].tobytes()


def filter_chunk(data: bytes, filters: List[Filter], itemsize: int) -> Tuple[bytes, int]:
    """Send one chunk through ``filters`` in pipeline order (the inverse of
    ``unfilter``); its bytes and its filter mask (bit i set: filter i not
    applied). Each filter takes its parameters from its client data, as
    HDF5's do; deflate and shuffle without client data fail in HDF5 (a
    shuffle over a variable-length type has none), and an optional filter
    that fails is skipped, its mask bit set, as HDF5 skips it."""
    mask = 0
    for i, flt in enumerate(filters):
        c = flt.client
        if flt.id in (DEFLATE, SHUFFLE) and not c:
            mask |= 1 << i
            continue
        if flt.id == DEFLATE:
            data = zlib.compress(data, c[0] if c else 6)
        elif flt.id == SHUFFLE:
            size = c[0] if c else itemsize
            n = len(data) // size
            if size > 1 and n > 1:
                body = np.frombuffer(data, dtype=np.uint8, count=n * size).reshape(n, size).T
                data = body.tobytes() + data[n * size:]
        elif flt.id == FLETCHER32:
            data = data + struct.pack("<I", fletcher32(data))
        elif flt.id == BZIP2:
            data = bz2.compress(data, c[0] if c and 1 <= c[0] <= 9 else 9)
        elif flt.id == LZF:
            data = _lzf_literals(data)
        elif flt.id == BLOSC:
            from gpsat_tpu_torch.data.blosc import blosc_encode

            code = c[6] if len(c) > 6 else 0
            data = blosc_encode(data, c[2] if len(c) > 2 and c[2] else itemsize, cname=BLOSC_ENCODERS[code],
                                shuffle=c[5] if len(c) > 5 else 1)
        else:
            raise FormatError(f"{flt.label()} has no encoder in this codec")
    return data, mask


# --------------------------------------------------------------------------
# version-2 B-trees (III.A.2)
# --------------------------------------------------------------------------


def btree2_records(read: Reader, addr: int, path: str, so: int = 8, sl: int = 8) -> Tuple[int, List[bytes]]:
    """The type and the records of the version-2 B-tree at ``addr``, in key
    order."""
    head = read(addr, 16 + so + 2 + sl + 4)
    if head[:4] != b"BTHD":
        raise FormatError(f"{path}: no version-2 B-tree header at {addr}")
    check_sum(head, path, f"the version-2 B-tree header at {addr}")
    btype, node_size, rec_size, depth = struct.unpack_from("<BIHH", head, 5)
    root, root_n = uint(head, 16, so), struct.unpack_from("<H", head, 16 + so)[0]
    if root == UNDEF:
        return btype, []
    # H5B2__hdr_init: the most records a node at each depth holds, and the
    # widths of the record counts stored beside each child pointer
    leaf_max = (node_size - 10) // rec_size
    count_size = limit_enc_size(leaf_max)
    cum_max, cum_size = [leaf_max], [0]
    for d in range(1, depth + 1):
        ptr = so + count_size + cum_size[d - 1]
        m = (node_size - (10 + ptr)) // (rec_size + ptr)
        cum_max.append((m + 1) * cum_max[d - 1] + m)
        cum_size.append(limit_enc_size(cum_max[d]))
    out: List[bytes] = []

    def walk(node: int, n: int, d: int) -> None:
        buf = read(node, node_size)
        sig = b"BTLF" if d == 0 else b"BTIN"
        if buf[:4] != sig or buf[5] != btype:
            raise FormatError(f"{path}: no version-2 B-tree {'leaf' if d == 0 else 'internal'} node at {node}")
        recs = [buf[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(n)]
        pos = 6 + n * rec_size
        if d == 0:
            check_sum(buf[:pos + 4], path, f"the version-2 B-tree node at {node}")
            out.extend(recs)
            return
        children = []
        for _ in range(n + 1):
            child = uint(buf, pos, so)
            cn = int.from_bytes(buf[pos + so:pos + so + count_size], "little")
            pos += so + count_size + cum_size[d - 1]
            children.append((child, cn))
        check_sum(buf[:pos + 4], path, f"the version-2 B-tree node at {node}")
        for i, (child, cn) in enumerate(children):
            walk(child, cn, d - 1)
            if i < n:
                out.append(recs[i])

    walk(root, root_n, depth)
    return btype, out


# --------------------------------------------------------------------------
# the chunk indexes of a version-4 layout (IV.A.2.i): fixed arrays,
# extensible arrays and version-2 B-trees of chunk records. Each returns
# (keys, addresses, sizes, filter masks) of the chunks it holds: keys are
# element indices (the arrays) or scaled offsets (the B-tree); sizes and
# masks are None where the chunks are not filtered. Elements of the
# undefined address, and pages never written, are missing chunks.
# --------------------------------------------------------------------------

Chunks = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]


def _bit(bitmap: bytes, i: int) -> bool:
    """Bit ``i`` of a page-init bitmap, the first bit the most significant
    (``H5VM_bit_get``)."""
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def _le(a: np.ndarray) -> np.ndarray:
    """Rows of little-endian bytes [n, width] as unsigned integers; all ones
    read as UNDEF."""
    out = np.zeros(len(a), np.uint64)
    for k in range(a.shape[1]):
        out |= a[:, k].astype(np.uint64) << np.uint64(8 * k)
    out[out == np.uint64((1 << 8 * a.shape[1]) - 1)] = np.uint64(UNDEF)
    return out


def _entries(raw: bytes, n: int, esize: int, filtered: bool, first: int, so: int = 8) -> Chunks:
    """``n`` elements of ``esize`` bytes, the first of index ``first``: a
    chunk's address (``so`` bytes), and for filtered chunks its size (in the
    element's bytes after the address but the last four) and its filter
    mask."""
    a = np.frombuffer(raw, np.uint8, n * esize).reshape(n, esize)
    addr = _le(a[:, :so])
    keep = addr != UNDEF
    idx = np.arange(first, first + n, dtype=np.int64)[keep]
    if not filtered:
        return idx, addr[keep], None, None
    size = _le(a[:, so:esize - 4])
    mask = a[:, esize - 4:esize].copy().view("<u4").reshape(-1)
    return idx, addr[keep], size[keep], mask[keep]


def _concat(parts: List[Chunks], filtered: bool) -> Chunks:
    if not parts:
        z = np.zeros(0, np.uint64)
        return np.zeros(0, np.int64), z, (z if filtered else None), (np.zeros(0, np.uint32) if filtered else None)
    cols = list(zip(*parts))
    return tuple(np.concatenate(c) if c[0] is not None else None for c in cols)


def fixed_array_chunks(read: Reader, addr: int, path: str, so: int = 8, sl: int = 8) -> Chunks:
    """The chunks of a fixed array (``FAHD``, then ``FADB``): one element
    per chunk of the chunk grid, in pages of 2^page_bits elements past that
    many, each page with its checksum and a bit in the data block's
    page-init bitmap."""
    head = _checked(read, addr, 8 + sl + so + 4, b"FAHD", path, "fixed array header")
    client, esize, page_bits = head[5], head[6], head[7]
    nelmts, dblk = uint(head, 8, sl), uint(head, 8 + sl, so)
    filtered = client == 1
    if dblk == UNDEF or nelmts == 0:
        return _concat([], filtered)
    page = 1 << page_bits
    npages = -(-nelmts // page) if nelmts > page else 0
    start = 6 + so  # signature, version, client, the header's address
    prefix = start + (npages + 7) // 8
    what = "fixed array data block"
    if not npages:
        buf = _checked(read, dblk, prefix + nelmts * esize + 4, b"FADB", path, what)
        return _entries(buf[prefix:], nelmts, esize, filtered, 0, so)
    bitmap = _checked(read, dblk, prefix + 4, b"FADB", path, what)[start:prefix]
    parts = []
    for p in range(npages):
        if _bit(bitmap, p):
            n = min(page, nelmts - p * page)
            at = dblk + prefix + 4 + p * (page * esize + 4)
            pbuf = _checked(read, at, n * esize + 4, b"", path, "fixed array data block page")
            parts.append(_entries(pbuf, n, esize, filtered, p * page, so))
    return _concat(parts, filtered)


def extensible_array_chunks(read: Reader, addr: int, path: str, so: int = 8, sl: int = 8) -> Chunks:
    """The chunks of an extensible array (``EAHD``): elements first in the
    index block (``EAIB``), then in data blocks (``EADB``) whose addresses
    the index block holds for the first super blocks and secondary blocks
    (``EASB``) hold for the rest; super block u has 2^(u // 2) data blocks of
    2^((u + 1) // 2) times the least data block's elements
    (``H5EA__hdr_init``). A data block of more than 2^page_bits elements is
    paged, its pages marked in its secondary block's page-init bitmap."""
    # twelve bytes, six lengths (the counts and sizes of blocks, the most
    # elements set, the elements), the index block's address, the checksum
    head = _checked(read, addr, 12 + 6 * sl + so + 4, b"EAHD", path, "extensible array header")
    client, esize, max_bits, iblk_elmts, dblk_min, sblk_min_ptrs, page_bits = head[5:12]
    iblock = uint(head, 12 + 6 * sl, so)
    filtered = client == 1
    if iblock == UNDEF:
        return _concat([], filtered)
    nsblks = 1 + max_bits - (dblk_min.bit_length() - 1)
    ndblks = [1 << (u // 2) for u in range(nsblks)]
    dblk_n = [(1 << ((u + 1) // 2)) * dblk_min for u in range(nsblks)]
    start_idx = np.concatenate([[0], np.cumsum([a * b for a, b in zip(ndblks, dblk_n)])]).tolist()
    start_dblk = np.concatenate([[0], np.cumsum(ndblks)]).tolist()
    off_size = (max_bits + 7) // 8
    page = 1 << page_bits
    in_iblock = 2 * (sblk_min_ptrs.bit_length() - 1)  # super blocks whose data blocks the index block holds
    n_dblk_addrs, n_sblk_addrs = 2 * (sblk_min_ptrs - 1), nsblks - in_iblock
    start = 6 + so  # a block's signature, version, class and header address
    size = start + iblk_elmts * esize + so * (n_dblk_addrs + n_sblk_addrs) + 4
    buf = _checked(read, iblock, size, b"EAIB", path, "extensible array index block")
    parts = [_entries(buf[start:], iblk_elmts, esize, filtered, 0, so)]
    pos = start + iblk_elmts * esize
    dblk_addrs = [uint(buf, pos + so * i, so) for i in range(n_dblk_addrs)]
    sblk_addrs = [uint(buf, pos + so * (n_dblk_addrs + i), so) for i in range(n_sblk_addrs)]
    dprefix = start + off_size  # and a data block's offset

    def data_block(a: int, u: int, j: int, pages: Optional[bytes]) -> None:
        """The j-th data block of super block u, at ``a``."""
        n, first = dblk_n[u], iblk_elmts + start_idx[u] + j * dblk_n[u]
        if pages is None:
            b = _checked(read, a, dprefix + n * esize + 4, b"EADB", path, "extensible array data block")
            parts.append(_entries(b[dprefix:], n, esize, filtered, first, so))
            return
        _checked(read, a, dprefix + 4, b"EADB", path, "extensible array data block")
        npages = n // page
        for p in range(npages):
            if _bit(pages, j * npages + p):
                b = _checked(read, a + dprefix + 4 + p * (page * esize + 4), page * esize + 4, b"", path,
                             "extensible array data block page")
                parts.append(_entries(b, page, esize, filtered, first + p * page, so))

    for u in range(in_iblock):
        if dblk_n[u] > page:
            raise FormatError(f"{path}: a paged data block in the extensible array index block at {iblock}")
        for j in range(ndblks[u]):
            if dblk_addrs[start_dblk[u] + j] != UNDEF:
                data_block(dblk_addrs[start_dblk[u] + j], u, j, None)
    for s, sblk in enumerate(sblk_addrs):
        if sblk == UNDEF:
            continue
        u = in_iblock + s
        paged = dblk_n[u] > page
        init = ndblks[u] * ((dblk_n[u] // page + 7) // 8) if paged else 0
        b = _checked(read, sblk, dprefix + init + so * ndblks[u] + 4, b"EASB", path,
                     "extensible array secondary block")
        pages = b[dprefix:dprefix + init] if paged else None
        for j in range(ndblks[u]):
            a = uint(b, dprefix + init + so * j, so)
            if a != UNDEF:
                data_block(a, u, j, pages)
    return _concat(parts, filtered)


def btree2_chunks(read: Reader, addr: int, path: str, rank: int, so: int = 8, sl: int = 8) -> Chunks:
    """The chunks of a version-2 B-tree of type 10 (unfiltered: an address
    and the scaled offsets) or 11 (filtered: an address, the chunk's size,
    its filter mask and the scaled offsets); keys are the scaled offsets,
    [n, rank]."""
    btype, recs = btree2_records(read, addr, path, so, sl)
    if btype not in (10, 11):
        raise FormatError(f"{path}: a chunk index of version-2 B-tree type {btype} at {addr}")
    n = len(recs)
    esize = (len(recs[0]) if n else so + 8 * rank + (so + 4 if btype == 11 else 0)) - 8 * rank
    a = np.frombuffer(b"".join(recs), np.uint8).reshape(n, esize + 8 * rank)
    scaled = a[:, esize:].copy().view("<u8").reshape(n, rank).astype(np.int64)
    idx, addrs, sizes, masks = _entries(a[:, :esize].tobytes(), n, esize, btype == 11, 0, so)
    return scaled[idx], addrs, sizes, masks


# --------------------------------------------------------------------------
# fractal heaps (III.G)
# --------------------------------------------------------------------------


class FractalHeap:
    """The fractal heap at ``addr``: ``get(heap_id)`` is an object's bytes.
    Managed objects come from direct blocks found by walking the doubling
    table of indirect blocks once; tiny objects from the ID itself; huge
    objects from their own blocks, through the heap's version-2 B-tree when
    the ID does not hold their address.

    A heap with I/O filters (a group created with a filter keeps its dense
    links in one) holds its pipeline in the header, after the root direct
    block's filtered size and filter mask; an indirect block then gives each
    direct child's filtered size and mask beside its address, and a huge
    object's mask and size before filtering sit beside its address in the ID
    or in the B-tree's records (type 2, else 1). Each block and huge object
    goes through ``unfilter`` before it is read; a direct block's checksum is
    over its bytes after."""

    def __init__(self, read: Reader, addr: int, path: str, so: int = 8, sl: int = 8):
        self._read, self.path, self.so, self.sl = read, path, so, sl
        # signature, version, ID length, filters' size, flags, the largest
        # managed object (14 bytes); the next huge ID, the huge objects'
        # B-tree, then the free space, its manager and counts of space and
        # objects (L O L O L L L L L L L L); the doubling table: width,
        # starting and largest direct block sizes, the heap's size in bits,
        # the root's starting rows, the root's address and its rows
        fixed = 22 + 12 * sl + 3 * so
        head = read(addr, fixed)
        if head[:4] != b"FRHP":
            raise FormatError(f"{path}: no fractal heap header at {addr}")
        self.id_len, filter_len, self.flags, self.max_man = struct.unpack_from("<HHBI", head, 5)
        self.huge_btree = uint(head, 14 + sl, so)
        pos = 14 + 10 * sl + 2 * so  # the doubling table
        self.width = struct.unpack_from("<H", head, pos)[0]
        self.start, self.max_direct = uint(head, pos + 2, sl), uint(head, pos + 2 + sl, sl)
        max_bits = struct.unpack_from("<H", head, pos + 2 + 2 * sl)[0]
        root = uint(head, pos + 6 + 2 * sl, so)
        rows = struct.unpack_from("<H", head, pos + 6 + 2 * sl + so)[0]
        size = fixed + (sl + 4 + filter_len if filter_len else 0) + 4
        full = read(addr, size)
        check_sum(full, path, f"the fractal heap header at {addr}")
        self.filters: List[Filter] = []
        root_size, root_mask = self.start, 0
        if filter_len:
            root_size, root_mask = uint(full, fixed, sl), struct.unpack_from("<I", full, fixed + sl)[0]
            self.filters = parse_filters(full[fixed + sl + 4:fixed + sl + 4 + filter_len])
            bad = check_filters(self.filters)
            if bad:
                raise FormatError(f"{path}: the fractal heap at {addr}: {bad}")
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((self.max_direct.bit_length() - 1 + 7) // 8, limit_enc_size(self.max_man))
        self.max_dblock_rows = (self.max_direct.bit_length() - 1) - (self.start.bit_length() - 1) + 2
        # (heap offset, address, size, stored size, filter mask) of each direct block
        self._blocks: List[Tuple[int, int, int, int, int]] = []
        self._cache: Dict[int, bytes] = {}
        self._huge: Optional[Dict[int, Tuple[int, int, int, int]]] = None
        if root != UNDEF:
            if rows == 0:
                self._blocks.append((0, root, self.start, root_size, root_mask))
            else:
                self._walk_indirect(root, rows, 0)
        self._blocks.sort()
        self._offsets = np.array([b[0] for b in self._blocks], dtype=np.int64)

    def _row_size(self, row: int) -> int:
        return self.start << max(row - 1, 0)

    def _walk_indirect(self, addr: int, rows: int, block_off: int) -> None:
        so, sl = self.so, self.sl
        k = min(rows, self.max_dblock_rows) * self.width
        n = max(rows - self.max_dblock_rows, 0) * self.width
        direct = so + (sl + 4 if self.filters else 0)  # a direct child: its address, and filtered, size and mask
        head = 5 + so + self.off_size
        buf = self._read(addr, head + direct * k + so * n + 4)
        if buf[:4] != b"FHIB":
            raise FormatError(f"{self.path}: no fractal heap indirect block at {addr}")
        check_sum(buf, self.path, f"the fractal heap indirect block at {addr}")
        off = block_off
        for i in range(k + n):
            row = i // self.width
            bsize = self._row_size(row)
            pos = head + direct * i if i < k else head + direct * k + so * (i - k)
            child = uint(buf, pos, so)
            if child != UNDEF:
                if i >= k:  # an indirect child: rows enough to span its size
                    sub_rows = (bsize.bit_length() - 1) - ((self.start * self.width).bit_length() - 1) + 1
                    self._walk_indirect(child, sub_rows, off)
                elif self.filters:
                    self._blocks.append((off, child, bsize, uint(buf, pos + so, sl),
                                         struct.unpack_from("<I", buf, pos + so + sl)[0]))
                else:
                    self._blocks.append((off, child, bsize, bsize, 0))
            off += bsize

    def _unfilter(self, data: bytes, mask: int, size: int, what: str) -> bytes:
        if not self.filters:
            return data
        return unfilter(data, self.filters, mask, 1, f"{self.path}: {what}", size)

    def _block(self, j: int) -> bytes:
        off, addr, size, stored, mask = self._blocks[j]
        buf = self._cache.get(j)
        if buf is None:
            buf = self._unfilter(self._read(addr, stored), mask, size, f"the fractal heap direct block at {addr}")
            if buf[:4] != b"FHDB":
                raise FormatError(f"{self.path}: no fractal heap direct block at {addr}")
            if self.flags & 2:  # checksummed direct blocks: the sum of the block with its field zeroed
                at = 5 + self.so + self.off_size
                stored_sum = struct.unpack_from("<I", buf, at)[0]
                if checksum(buf[:at] + b"\0\0\0\0" + buf[at + 4:]) != stored_sum:
                    raise FormatError(f"{self.path}: the checksum of the fractal heap direct block at {addr} "
                                      "does not match")
            self._cache[j] = buf
        return buf

    def _huge_records(self) -> Dict[int, Tuple[int, int, int, int]]:
        """The huge objects' B-tree: ID -> (address, stored size, filter
        mask, size)."""
        if self._huge is None:
            so, sl = self.so, self.sl
            btype, recs = btree2_records(self._read, self.huge_btree, self.path, so, sl)
            want = 2 if self.filters else 1
            if btype != want:
                raise FormatError(f"{self.path}: huge fractal heap objects under a version-2 B-tree of type "
                                  f"{btype}; this heap's are of type {want}")
            self._huge = {}
            for r in recs:
                a, n = uint(r, 0, so), uint(r, so, sl)
                if self.filters:  # address, stored size, mask, size, ID
                    mask, size = struct.unpack_from("<I", r, so + sl)[0], uint(r, so + sl + 4, sl)
                    self._huge[uint(r, so + 2 * sl + 4, sl)] = (a, n, mask, size)
                else:  # address, size, ID
                    self._huge[uint(r, so + sl, sl)] = (a, n, 0, n)
        return self._huge

    def get(self, heap_id: bytes) -> bytes:
        b0 = heap_id[0]
        kind = (b0 >> 4) & 3
        if b0 >> 6:
            raise FormatError(f"{self.path}: fractal heap ID version {b0 >> 6}")
        if kind == 0:  # managed: an offset in the heap's address space and a length
            off = int.from_bytes(heap_id[1:1 + self.off_size], "little")
            n = int.from_bytes(heap_id[1 + self.off_size:1 + self.off_size + self.len_size], "little")
            j = int(np.searchsorted(self._offsets, off, side="right")) - 1
            if j < 0 or off + n > self._blocks[j][0] + self._blocks[j][2]:
                raise FormatError(f"{self.path}: fractal heap offset {off} lies in no direct block")
            lo = off - self._blocks[j][0]
            return self._block(j)[lo:lo + n]
        if kind == 2:  # tiny: the bytes are in the ID
            # the length in the ID's first byte while the ID holds at most 16
            # bytes after it, and also at 18 bytes, where a second length byte
            # would leave room for no more (HDF5's H5HF__tiny_init); in two
            # bytes beyond that
            if self.id_len <= 18:
                n = (b0 & 0x0F) + 1
                return heap_id[1:1 + n]
            n = (((b0 & 0x0F) << 8) | heap_id[1]) + 1
            return heap_id[2:2 + n]
        if kind == 1:  # huge: in a block of its own, its address in the ID where the ID has room for it
            so, sl = self.so, self.sl
            if self.filters and self.id_len >= 1 + so + 2 * sl + 4:
                a, n, mask, size = uint(heap_id, 1, so), uint(heap_id, 1 + so, sl), \
                    struct.unpack_from("<I", heap_id, 1 + so + sl)[0], uint(heap_id, 5 + so + sl, sl)
            elif not self.filters and self.id_len >= 1 + so + sl:
                a, n = uint(heap_id, 1, so), uint(heap_id, 1 + so, sl)
                mask, size = 0, n
            else:
                key = int.from_bytes(heap_id[1:self.id_len], "little")
                if key not in self._huge_records():
                    raise FormatError(f"{self.path}: no huge fractal heap object {key}")
                a, n, mask, size = self._huge[key]
            return self._unfilter(self._read(a, n), mask, size, f"the huge fractal heap object at {a}")
        raise FormatError(f"{self.path}: fractal heap ID of type {kind}")
