"""A msgpack encoder and decoder for the checkpoint's META file.

The checkpoint layout stores its metadata in msgpack, and the machines the
port runs on need not have the ``msgpack`` package, so the port carries
this subset: None, bool, int (64-bit), float (as float64), str, bytes,
lists and tuples (as arrays) and dicts (as maps).  ``packb`` writes the
smallest encoding of each value, as ``msgpack.packb`` does with its
defaults (``use_bin_type=True``), so the two agree byte for byte on these
types; ``unpackb`` reads them back (str as str, arrays as lists) and also
accepts float32.
"""

from __future__ import annotations

import struct


def _pack_int(v: int, out: bytearray) -> None:
    if v < -(1 << 63) or v >= 1 << 64:
        raise OverflowError(f"{v} does not fit msgpack's 64-bit integers")
    if v < -(1 << 5):
        for bound, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if v >= -bound:
                out += bytes([code]) + struct.pack(fmt, v)
                return
    if v < 1 << 7:  # positive and negative fixint
        out += struct.pack(">b", v)
        return
    for bound, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                             (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
        if v < bound:
            out += bytes([code]) + struct.pack(fmt, v)
            return


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the smallest
    of ``codes`` (8-, 16- and 32-bit lengths; None where there is none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for bound, code, fmt in zip((1 << 8, 1 << 16, 1 << 32), codes, (">B", ">H", ">I")):
        if code is not None and n < bound:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} is too long for msgpack")


def _pack(v, out: bytearray) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(v, out)
    elif isinstance(v, float):
        out += b"\xcb" + struct.pack(">d", v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(v, (bytes, bytearray, memoryview)):
        data = bytes(v)
        _pack_len(len(data), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(v, (list, tuple)):
        _pack_len(len(v), out, 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(item, out)
    elif isinstance(v, dict):
        _pack_len(len(v), out, 0x80, 16, (None, 0xDE, 0xDF))
        for key, item in v.items():
            _pack(key, out)
            _pack(item, out)
    else:
        raise TypeError(f"cannot pack {type(v).__name__} into msgpack")


def packb(v) -> bytes:
    out = bytearray()
    _pack(v, out)
    return bytes(out)


_FIXED = {  # code: (struct format, size) of the scalars with a fixed width
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4,  # bin, str
        0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4}  # array, map
_LEN_FMT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.items(code & 0x0F, is_map=True)
        if 0x90 <= code <= 0x9F:
            return self.items(code & 0x0F, is_map=False)
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        if code in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[code]
        if code in _FIXED:
            fmt, size = _FIXED[code]
            return struct.unpack(fmt, self.take(size))[0]
        if code in _LEN:
            size = _LEN[code]
            n = struct.unpack(_LEN_FMT[size], self.take(size))[0]
            if code <= 0xC6:
                return bytes(self.take(n))
            if code <= 0xDB:
                return str(self.take(n), "utf-8")
            return self.items(n, is_map=code >= 0xDE)
        raise ValueError(f"msgpack type 0x{code:02x} is outside the checkpoint codec's subset")

    def items(self, n: int, is_map: bool):
        if not is_map:
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes):
    reader = _Reader(data)
    v = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack value")
    return v
