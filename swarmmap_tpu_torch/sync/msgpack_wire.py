"""MessagePack for the sync codec, in plain Python.

The JAX package packs its wire and its map files with the `msgpack`
package (swarmmap_tpu/sync/codec.py:19, `packb(..., use_bin_type=True)`,
`unpackb(..., raw=False, strict_map_key=False)`).  The port does not depend
on that package: this module packs and unpacks the subset of the format
that the codec uses, to the same bytes.

- `packb`: None, bool, int (-2**63 .. 2**64-1, each in the smallest
  encoding, negative fixint first), float (float64), str, bytes /
  bytearray / memoryview (bin), list and tuple (array), dict (map, in
  insertion order).  Any other object goes once through `default`, whose
  result is packed instead, as msgpack does.  Checks are `isinstance`
  checks in msgpack's order, so a numpy float64 (a float subclass) packs
  as a float without `default`.
- `unpackb`: the whole format but ext types and float32 (which the codec
  never writes; float32 is read all the same), arrays as lists, str as
  str, bin as bytes, map keys of any type; `object_hook` is called on
  each map once its items are read, innermost first.
"""
from __future__ import annotations

import struct
from typing import Any, Callable

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _int(n: int) -> bytes:
    if n >= 0:
        if n < 0x80:
            return _U8.pack(n)
        if n <= 0xFF:
            return b"\xcc" + _U8.pack(n)
        if n <= 0xFFFF:
            return b"\xcd" + _U16.pack(n)
        if n <= 0xFFFFFFFF:
            return b"\xce" + _U32.pack(n)
        if n <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + _U64.pack(n)
    else:
        if n >= -32:
            return _I8.pack(n)
        if n >= -0x80:
            return b"\xd0" + _I8.pack(n)
        if n >= -0x8000:
            return b"\xd1" + _I16.pack(n)
        if n >= -0x80000000:
            return b"\xd2" + _I32.pack(n)
        if n >= -0x8000000000000000:
            return b"\xd3" + _I64.pack(n)
    raise OverflowError("Integer value out of range")


def _head(n: int, fix: int | None, fix_max: int, w8: bytes | None, w16: bytes,
          w32: bytes, what: str) -> bytes:
    """The header of a str, bin, array or map of length n."""
    if fix is not None and n < fix_max:
        return _U8.pack(fix | n)
    if w8 is not None and n <= 0xFF:
        return w8 + _U8.pack(n)
    if n <= 0xFFFF:
        return w16 + _U16.pack(n)
    if n <= 0xFFFFFFFF:
        return w32 + _U32.pack(n)
    raise ValueError(f"{what} is too large")


def _pack(obj: Any, out: list, default: Callable | None) -> None:
    default_used = False
    while True:
        if obj is None:
            out.append(b"\xc0")
        elif isinstance(obj, bool):
            out.append(b"\xc3" if obj else b"\xc2")
        elif isinstance(obj, int):
            out.append(_int(obj))
        elif isinstance(obj, (bytes, bytearray)):
            out.append(_head(len(obj), None, 0, b"\xc4", b"\xc5", b"\xc6", "bytes object"))
            out.append(bytes(obj))
        elif isinstance(obj, str):
            b = obj.encode("utf-8")
            out.append(_head(len(b), 0xA0, 32, b"\xd9", b"\xda", b"\xdb", "String"))
            out.append(b)
        elif isinstance(obj, memoryview):
            out.append(_head(obj.nbytes, None, 0, b"\xc4", b"\xc5", b"\xc6", "Memoryview"))
            out.append(obj.tobytes())
        elif isinstance(obj, float):
            out.append(b"\xcb" + _F64.pack(obj))
        elif isinstance(obj, (list, tuple)):
            out.append(_head(len(obj), 0x90, 16, None, b"\xdc", b"\xdd", "list"))
            for x in obj:
                _pack(x, out, default)
        elif isinstance(obj, dict):
            out.append(_head(len(obj), 0x80, 16, None, b"\xde", b"\xdf", "dict"))
            for k, v in obj.items():
                _pack(k, out, default)
                _pack(v, out, default)
        elif default is not None and not default_used:
            obj, default_used = default(obj), True
            continue
        else:
            raise TypeError(f"Cannot serialize {obj!r}")
        return


def packb(obj: Any, default: Callable | None = None) -> bytes:
    """The bytes of msgpack.packb(obj, default=default, use_bin_type=True)."""
    out: list[bytes] = []
    _pack(obj, out, default)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes, object_hook: Callable | None):
        self.buf = memoryview(data)
        self.pos = 0
        self.hook = object_hook

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        self.pos = p + n
        return self.buf[p:p + n]

    def num(self, s: struct.Struct):
        return s.unpack(self.take(s.size))[0]

    def items(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> Any:
        d = {}
        for _ in range(n):
            k = self.obj()
            d[k] = self.obj()
        return self.hook(d) if self.hook is not None else d

    def obj(self) -> Any:
        t = self.num(_U8)
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t < 0x90:
            return self.map(t & 0x0F)
        if t < 0xA0:
            return self.items(t & 0x0F)
        if t < 0xC0:
            return str(self.take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.num((_U8, _U16, _U32)[t - 0xC4])))
        if t == 0xCA:
            return self.num(_F32)
        if t == 0xCB:
            return self.num(_F64)
        if 0xCC <= t <= 0xCF:
            return self.num((_U8, _U16, _U32, _U64)[t - 0xCC])
        if 0xD0 <= t <= 0xD3:
            return self.num((_I8, _I16, _I32, _I64)[t - 0xD0])
        if t in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.num((_U8, _U16, _U32)[t - 0xD9])), "utf-8")
        if t in (0xDC, 0xDD):
            return self.items(self.num((_U16, _U32)[t - 0xDC]))
        if t in (0xDE, 0xDF):
            return self.map(self.num((_U16, _U32)[t - 0xDE]))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")


def unpackb(data: bytes, object_hook: Callable | None = None) -> Any:
    """msgpack.unpackb(data, object_hook=object_hook, raw=False,
    strict_map_key=False) for what `packb` writes."""
    r = _Reader(data, object_hook)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("extra data after the msgpack object")
    return obj
