"""A small msgpack writer/reader for the subset the chunk wire format uses.

:func:`repro_torch.core.bitstream.pack` writes ``{"h": header, "a": arrays}``
where every value is a map, a string, a byte string, an integer or a list of
integers.  This module encodes exactly that subset the way
``msgpack.packb(obj, use_bin_type=True)`` does — the shortest form of each
type, maps in insertion order — so the port's blobs are byte-identical to
the reference's without the ``msgpack`` package:

* maps: fixmap, map16, map32;
* strings (UTF-8): fixstr, str8, str16, str32;
* byte strings: bin8, bin16, bin32;
* integers: positive/negative fixint, uint8..uint64, int8..int64;
* lists/tuples: fixarray, array16, array32;
* ``None``, ``False``, ``True``.

The TCP transport's request and response-header frames (maps of strings,
integers, booleans, ``None`` and lists of them) fall in the same subset.

:class:`Reader` decodes the same subset from a byte buffer and reports byte
offsets (:meth:`Reader.tell`), which the segment index needs.  Anything it
cannot parse — an unknown type byte, a truncated object — raises
:class:`IntegrityError`: to the serving layer a blob that does not parse is
indistinguishable from a corrupted one.  :func:`unpackb` reads one whole
frame and, like ``msgpack.unpackb``, refuses bytes left after its object.
"""
from __future__ import annotations

import struct
from typing import Any, List

__all__ = ["IntegrityError", "Reader", "packb", "unpackb"]


class IntegrityError(ValueError):
    """A packed chunk failed its checksum or could not be parsed — the
    bytes were corrupted in storage or in transit (retryable, unlike a
    plan/header mismatch which points at the wrong blob being returned)."""


def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(bytes([n]))
    elif n >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < lim:
                out.append(bytes([tag]) + struct.pack(fmt, n))
                return
        raise TypeError(f"integer {n} does not fit in uint64")
    elif n >= -32:
        out.append(struct.pack(">b", n))
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -lim:
                out.append(bytes([tag]) + struct.pack(fmt, n))
                return
        raise TypeError(f"integer {n} does not fit in int64")


def _pack_len(n: int, fix_tag: int, fix_lim: int, tags, out: List[bytes]) -> None:
    """Length prefix: a fix-form under ``fix_lim``, else 8/16/32-bit forms
    (``tags`` gives the type bytes, ``None`` where the width does not exist)."""
    if fix_tag is not None and n < fix_lim:
        out.append(bytes([fix_tag | n]))
        return
    for tag, fmt, lim in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < lim:
            out.append(bytes([tag]) + struct.pack(fmt, n))
            return
    raise TypeError(f"length {n} too large for msgpack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is False:
        out.append(b"\xc2")
    elif obj is True:
        out.append(b"\xc3")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(b)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} in the chunk wire subset")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the supported subset."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_ARR = {0xDC: ">H", 0xDD: ">I"}


class Reader:
    """Sequential decoder over one buffer; strings come back as ``str``,
    binaries as ``bytes``."""

    def __init__(self, buf: bytes, pos: int = 0):
        self._buf = memoryview(buf)
        self._pos = pos

    def tell(self) -> int:
        """Byte offset of the next object."""
        return self._pos

    def _take(self, n: int) -> memoryview:
        end = self._pos + n
        if end > len(self._buf):
            raise IntegrityError(
                f"msgpack object truncated: need {n} bytes at offset {self._pos}, "
                f"buffer holds {len(self._buf)}"
            )
        view = self._buf[self._pos:end]
        self._pos = end
        return view

    def _num(self, fmt: str) -> int:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read_map_header(self) -> int:
        """Read a map's length prefix and return its entry count."""
        tag = self._take(1)[0]
        if 0x80 <= tag <= 0x8F:
            return tag & 0x0F
        if tag in _MAP:
            return self._num(_MAP[tag])
        raise IntegrityError(f"expected a msgpack map, got type byte {tag:#04x}")

    def read(self) -> Any:
        tag = self._take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F or tag in _MAP:
            n = tag & 0x0F if tag <= 0x8F else self._num(_MAP[tag])
            out = {}
            for _ in range(n):
                k = self.read()
                if isinstance(k, (dict, list)):
                    raise IntegrityError("unhashable msgpack map key")
                out[k] = self.read()
            return out
        if 0x90 <= tag <= 0x9F or tag in _ARR:
            n = tag & 0x0F if tag <= 0x9F else self._num(_ARR[tag])
            return [self.read() for _ in range(n)]
        if 0xA0 <= tag <= 0xBF or tag in _STR:
            n = tag & 0x1F if tag <= 0xBF else self._num(_STR[tag])
            try:
                return bytes(self._take(n)).decode("utf-8")
            except UnicodeDecodeError as e:
                raise IntegrityError(f"msgpack string is not UTF-8: {e}") from e
        if tag in _BIN:
            return bytes(self._take(self._num(_BIN[tag])))
        if tag in _UINT:
            return self._num(_UINT[tag])
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        raise IntegrityError(f"msgpack type byte {tag:#04x} is outside the chunk wire subset")

    def skip(self) -> None:
        """Advance past one object."""
        self.read()


def unpackb(buf: bytes) -> Any:
    """``msgpack.unpackb(buf, raw=False)`` for the supported subset: one
    object filling ``buf`` exactly.  Bytes after it raise
    :class:`IntegrityError`, as ``msgpack`` raises ``ExtraData``."""
    reader = Reader(buf)
    obj = reader.read()
    if reader.tell() != len(buf):
        raise IntegrityError(
            f"msgpack frame holds {len(buf) - reader.tell()} bytes after its object"
        )
    return obj
