"""A reader of the msgpack files that flax writes, in numpy alone.

The JAX package saves its checkpoints (``chkpt_seed{seed}.msgpack``) and
its FGD net with ``flax.serialization.to_bytes``: msgpack of a tree of
maps (string keys), arrays and scalars, arrays as msgpack extension 1
(``(shape, dtype name, C-order bytes)``, itself msgpack) and numpy scalars
as extension 3; arrays above 2**30 bytes are split into a map of chunks
(``__msgpack_chunked_array__``).  ``loads`` decodes that subset of msgpack
(maps, arrays, str, bin, ints, floats, nil, bool, the extensions) into
dicts, lists, numpy arrays and Python scalars, as
``flax.serialization.msgpack_restore`` does, without the ``msgpack``
package, which the card's machine does not have.  ``bfloat16`` arrays come
back as float32 (exactly), since numpy has no bfloat16.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
                 0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
                 0xdc: (">H", "array"), 0xdd: (">I", "array"),
                 0xde: (">H", "map"), 0xdf: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                   0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xc7, 0xc8, 0xc9):
            return self.ext(self.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} is not "
                         "one flax writes")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = loads(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack extension {code} is not one flax writes")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buffer = loads(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()


def _by_index(d: dict) -> list:
    return [d[k] for k in sorted(d, key=int)]


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape: Tuple[int, ...] = tuple(_by_index(tree["shape"]))
            return np.concatenate(_by_index(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` returns."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack object")
    return _unchunk(tree)


def load(path: str) -> Any:
    """``loads`` of a file; a file that does not decode raises
    ``ValueError`` naming it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return loads(data)
    except (ValueError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: not a flax msgpack file ({e})") from e
