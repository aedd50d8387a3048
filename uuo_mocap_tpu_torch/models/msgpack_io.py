"""Read and write the msgpack files that ``flax.serialization.to_bytes``
writes, without flax or msgpack.

``to_bytes`` packs a nested state dict with ``msgpack.packb``: maps with
str keys, and every array leaf as an extension of type 1 whose payload is
itself a packed ``(shape, dtype name, C-order bytes)``.  ``unpackb``
decodes exactly those types: maps, str, bin, ints, arrays and the ndarray
extension.  Any other type raises ``ValueError`` naming it (flax writes no
other for a params tree).  ``packb`` writes them, each in msgpack's
shortest form, as ``msgpack.packb`` does, so its bytes equal ``to_bytes``'s
for the same tree.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1

# fixed-size headers: first byte -> (kind, size of the length/value field)
_SIZED = {
    0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
    0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
    0xcc: ("uint", 1), 0xcd: ("uint", 2), 0xce: ("uint", 4), 0xcf: ("uint", 8),
    0xd0: ("int", 1), 0xd1: ("int", 2), 0xd2: ("int", 4), 0xd3: ("int", 8),
    0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
    0xdc: ("array", 2), 0xdd: ("array", 4),
    0xde: ("map", 2), 0xdf: ("map", 4),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UNSUPPORTED = {0xc0: "nil", 0xc2: "false", 0xc3: "true", 0xca: "float32", 0xcb: "float64"}
_UINT = {1: ">B", 2: ">H", 4: ">I", 8: ">Q"}
_INT = {1: ">b", 2: ">h", 4: ">i", 8: ">q"}


def _read(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise ValueError(f"msgpack data truncated at byte {pos} (needs {n} more)")
    return buf[pos:pos + n], pos + n


def _ext(code: int, data: memoryview) -> np.ndarray:
    if code != _EXT_NDARRAY:
        raise ValueError(f"msgpack extension type {code} is not supported (only 1, ndarray)")
    (shape, dtype_name, raw), end = _decode(data, 0)
    if end != len(data):
        raise ValueError("trailing bytes in an ndarray extension")
    return np.frombuffer(bytes(raw), dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _decode(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _decode_map(buf, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _decode_array(buf, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        raw, pos = _read(buf, pos, b & 0x1f)
        return str(raw, "utf-8"), pos
    if b in _FIXEXT:
        head, pos = _read(buf, pos, 1)
        data, pos = _read(buf, pos, _FIXEXT[b])
        return _ext(struct.unpack(">b", head)[0], data), pos
    if b in _SIZED:
        kind, size = _SIZED[b]
        field, pos = _read(buf, pos, size)
        if kind == "int":
            return struct.unpack(_INT[size], field)[0], pos
        n = struct.unpack(_UINT[size], field)[0]
        if kind == "uint":
            return n, pos
        if kind == "map":
            return _decode_map(buf, pos, n)
        if kind == "array":
            return _decode_array(buf, pos, n)
        if kind == "ext":
            head, pos = _read(buf, pos, 1)
            data, pos = _read(buf, pos, n)
            return _ext(struct.unpack(">b", head)[0], data), pos
        raw, pos = _read(buf, pos, n)
        return (str(raw, "utf-8") if kind == "str" else bytes(raw)), pos
    raise ValueError(f"msgpack type {_UNSUPPORTED.get(b, hex(b))} at byte {pos - 1} is not "
                     "supported (a flax params file holds maps, str, bin, ints, arrays and "
                     "ndarray extensions)")


def _decode_array(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _decode(buf, pos)
        out.append(item)
    return out, pos


def _decode_map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos)
        out[key], pos = _decode(buf, pos)
    return out, pos


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (a flax state dict: nested dicts of numpy
    arrays) from ``data``."""
    buf = memoryview(data)
    if not len(buf):
        raise ValueError("empty msgpack data")
    obj, end = _decode(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the msgpack object")
    return obj


def _pack_uint(n: int, fix_max: int, fix_base: int, codes) -> bytes:
    """The shortest header for a length or count ``n``: a fix form below
    ``fix_max``, else the first of ``codes`` (1-, 2-, 4-byte fields; None
    where msgpack has no such form) that holds it."""
    if n < fix_max:
        return bytes([fix_base | n])
    for code, size in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * size):
            return bytes([code]) + n.to_bytes(size, "big")
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n >= 0:
        for code, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")):
            if n < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, n)
    for code, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q")):
        if n >= -(1 << (8 * struct.calcsize(fmt) - 1)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack's 64 bits")


_EXT_FIXED = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _pack(obj: Any, out: list) -> None:
    if isinstance(obj, dict):
        out.append(_pack_uint(len(obj), 16, 0x80, (None, 0xde, 0xdf)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_uint(len(obj), 16, 0x90, (None, 0xdc, 0xdd)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += [_pack_uint(len(raw), 32, 0xa0, (0xd9, 0xda, 0xdb)), raw]
    elif isinstance(obj, bytes):
        out += [_pack_uint(len(obj), 0, 0, (0xc4, 0xc5, 0xc6)), obj]
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        out.append(_pack_int(int(obj)))
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > 1 << 30:
            raise ValueError("arrays over 1 GiB are chunked by flax, and not written here")
        if obj.dtype.hasobject or obj.dtype.isalignedstruct:
            raise ValueError(f"dtype {obj.dtype} cannot be written")
        data = packb((obj.shape, obj.dtype.name, obj.tobytes("C")))
        if len(data) in _EXT_FIXED:
            out.append(bytes([_EXT_FIXED[len(data)]]))
        else:
            out.append(_pack_uint(len(data), 0, 0, (0xc7, 0xc8, 0xc9)))
        out += [struct.pack(">b", _EXT_NDARRAY), data]
    else:
        raise ValueError(f"cannot write {type(obj).__name__} (a flax params file holds maps, "
                         "str, ints and arrays)")


def packb(obj: Any) -> bytes:
    """Encode a flax state dict (nested str-keyed dicts of numpy arrays;
    tuples, str, bytes and ints inside) as ``flax.serialization.to_bytes``
    does.  Arrays over flax's 1 GiB chunk size are not split: they raise."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)
