"""LZF, the compressor of h5py's "lzf" HDF5 filter (id 32000).

h5py's filter (``lzf/lzf_filter.c``) compresses each chunk with liblzf
and keeps the chunk's byte size in its third client value; a chunk that
LZF cannot shrink is stored raw, its filter-mask bit set. The decode loop
runs in the C++ host library (``gpsat_tpu_torch/csrc/host/gpsat_native.cpp``)
with ``decoder="native"``, the default; ``decoder="python"`` takes the
pure-Python loop here, its plain version. Neither gives way to the other:
a failed build of the host library raises.
"""

from __future__ import annotations

DECODERS = ("native", "python")


def _lzf_decompress_py(buf: bytes, dst_len: int) -> bytes:
    """LZF decode in pure Python (liblzf's ``lzf_decompress``): a control
    byte below 32 starts ctrl + 1 literals; else its top three bits are the
    match length less two (7: one more length byte follows) and its low
    five bits, with the next byte, the distance back less one."""
    out = bytearray()
    ip, n = 0, len(buf)
    while ip < n:
        ctrl = buf[ip]
        ip += 1
        if ctrl < 32:
            lit = ctrl + 1
            if ip + lit > n or len(out) + lit > dst_len:
                raise ValueError(f"corrupt lzf stream: it does not decode into {dst_len} bytes")
            out += buf[ip:ip + lit]
            ip += lit
            continue
        length = ctrl >> 5
        if length == 7:
            if ip >= n:
                raise ValueError("corrupt lzf stream: truncated match length")
            length += buf[ip]
            ip += 1
        if ip >= n:
            raise ValueError("corrupt lzf stream: truncated match distance")
        back = ((ctrl & 0x1F) << 8) + buf[ip] + 1
        ip += 1
        length += 2
        if back > len(out) or len(out) + length > dst_len:
            raise ValueError(f"corrupt lzf stream: it does not decode into {dst_len} bytes")
        start = len(out) - back
        if back >= length:
            out += out[start:start + length]
        else:  # the match overlaps what it writes: a run of its last ``back`` bytes
            for i in range(length):
                out.append(out[start + i])
    return bytes(out)


def lzf_decode(buf: bytes, dst_len: int, decoder: str = "native") -> bytes:
    """The bytes of one LZF stream, at most ``dst_len`` of them; raises
    ``ValueError`` on a corrupt or overflowing stream."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if decoder == "python":
        return _lzf_decompress_py(bytes(buf), dst_len)
    from gpsat_tpu_torch import native

    return native.lzf_decompress(buf, dst_len)
