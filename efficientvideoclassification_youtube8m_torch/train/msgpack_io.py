"""A pure-Python msgpack codec (`struct` + numpy) for the subset that
`flax.serialization` writes, so the port reads and writes the JAX
package's checkpoints without flax or msgpack.

The subset: maps with string keys, arrays (lists and tuples), ints,
floats, bools, nil, str and bin, and the flax extension types

  * ext 1, an ndarray: the payload is the msgpack array ``[shape,
    dtype.name, bytes in C order]`` (``flax.serialization._ndarray_to_bytes``);
  * ext 3, a numpy scalar in the same payload (read only);
  * ext 2, a Python complex as ``[real, imag]`` (read only).

Encodings are the smallest, the ones msgpack-python picks, so a tree
written here is byte for byte what ``msgpack.packb`` with flax's
extension hook gives for the same tree in the same key order.

`dump` streams each array's bytes straight to the file, without joining
the state into one bytes object. `load` reads the file into one buffer
and makes each array leaf a zero-copy view of it. flax splits a leaf of
more than ``2**30`` bytes into a ``__msgpack_chunked_array__`` map; no
leaf of this system comes near that (the largest, the flagship MoE gate
weights, is 232 MB), so both directions raise on it.
"""

from __future__ import annotations

import os
import struct
from typing import Any, BinaryIO, Callable, Optional

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax chunks array leaves above this size
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_DTYPES = {np.dtype(name).name: np.dtype(name) for name in (
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "complex64", "complex128")}


# ---------------------------------------------------------------- writing

def _sized(n: int, small: int, small_max: int, codes) -> bytes:
    """The header of a str/bin/map/array of length `n`: a fix-form byte
    `small | n` when n <= small_max (small=None: none), else the 8/16/32-bit
    length form of `codes`."""
    if small is not None and n <= small_max:
        return bytes([small | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack's 32-bit lengths")


def _str_header(n: int) -> bytes:
    return _sized(n, 0xA0, 31, (0xD9, 0xDA, 0xDB))


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, (None, 0xDE, 0xDF))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, (None, 0xDC, 0xDD))


def _int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        forms = ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32),
                 (0xCF, ">Q", 2**64))
        for code, fmt, limit in forms:
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        forms = ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15), (0xD2, ">i", 2**31),
                 (0xD3, ">q", 2**63))
        for code, fmt, limit in forms:
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit 64 bits")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _str_header(len(raw)) + raw


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    head = _sized(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _write_ndarray(f: BinaryIO, arr: np.ndarray, code: int) -> None:
    if arr.dtype.name not in _DTYPES:
        raise ValueError(f"unsupported array dtype {arr.dtype}")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(
            f"an array leaf of {arr.nbytes} bytes exceeds 2**30; flax would "
            "write it in chunks, which this codec does not")
    if not arr.dtype.isnative:
        arr = arr.astype(arr.dtype.newbyteorder("="))
    inner = (b"\x93" + _array_header(arr.ndim) + b"".join(map(_int, arr.shape))
             + _str(arr.dtype.name) + _bin_header(arr.nbytes))
    f.write(_ext_header(len(inner) + arr.nbytes, code) + inner)
    f.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def dump(tree: Any, f: BinaryIO,
         default: Optional[Callable[[Any], Any]] = None) -> None:
    """Write `tree` to the binary file `f`. `default` converts a leaf of
    another type (a torch tensor, say) into one of the subset, as
    msgpack's `default` hook does; it is called once per such leaf, just
    before the leaf is written."""

    def write(node: Any) -> None:
        if isinstance(node, dict):
            f.write(_map_header(len(node)))
            for key, value in node.items():
                if not isinstance(key, str):
                    raise TypeError(f"map key {key!r} is not a str")
                f.write(_str(key))
                write(value)
        elif isinstance(node, np.ndarray):
            _write_ndarray(f, node, EXT_NDARRAY)
        elif isinstance(node, np.generic):
            _write_ndarray(f, np.asarray(node), EXT_NPSCALAR)
        elif node is None:
            f.write(b"\xc0")
        elif isinstance(node, bool):
            f.write(b"\xc3" if node else b"\xc2")
        elif isinstance(node, int):
            f.write(_int(node))
        elif isinstance(node, float):
            f.write(b"\xcb" + struct.pack(">d", node))
        elif isinstance(node, str):
            f.write(_str(node))
        elif isinstance(node, (bytes, bytearray)):
            f.write(_bin_header(len(node)) + bytes(node))
        elif isinstance(node, (list, tuple)):
            f.write(_array_header(len(node)))
            for value in node:
                write(value)
        elif default is not None:
            write(default(node))
        else:
            raise TypeError(f"cannot serialize a {type(node).__name__}")

    write(tree)


def dumps(tree: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """`dump` into a bytes object (for small trees and tests)."""
    import io

    buf = io.BytesIO()
    dump(tree, buf, default)
    return buf.getvalue()


# ---------------------------------------------------------------- reading

class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.mv = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.mv):
            raise ValueError("truncated msgpack data")
        return start

    def unpack(self, fmt: str):
        start = self.take(struct.calcsize(fmt))
        return struct.unpack_from(fmt, self.mv, start)[0]

    def str_(self, n: int) -> str:
        start = self.take(n)
        return str(self.mv[start:start + n], "utf-8")

    def bin_(self, n: int):
        """(offset, length) of a bin payload in the buffer."""
        return self.take(n), n

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            offset, n = self.bin_(self.unpack((">B", ">H", ">I")[b - 0xC4]))
            return bytes(self.mv[offset:offset + n])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack((">B", ">H", ">I")[b - 0xC7]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise ValueError(
                "a chunked array leaf (flax's form for leaves over 2**30 "
                "bytes) is not supported")
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        end = self.pos + n
        if code == EXT_COMPLEX:
            real, imag = self.read()
            value = complex(real, imag)
        elif code in (EXT_NDARRAY, EXT_NPSCALAR):
            value = self.ndarray()
            if code == EXT_NPSCALAR:
                value = value[()]
        else:
            raise ValueError(f"msgpack extension type {code} is not supported")
        if self.pos != end:
            raise ValueError(f"malformed extension payload of type {code}")
        return value

    def ndarray(self) -> np.ndarray:
        if self.unpack(">B") != 0x93:
            raise ValueError("an ndarray payload is not a 3-element array")
        shape, name = self.read(), self.read()
        if isinstance(name, bytes):
            name = name.decode("utf-8")
        if not (isinstance(shape, list) and isinstance(name, str)):
            raise ValueError("an ndarray payload does not start with a shape "
                             "and a dtype name")
        dtype = _DTYPES.get(name)
        if dtype is None:
            raise ValueError(f"unknown array dtype name {name!r}; known: "
                             f"{sorted(_DTYPES)}")
        b = self.unpack(">B")
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError("an ndarray payload's data is not bin")
        offset, n = self.bin_(self.unpack((">B", ">H", ">I")[b - 0xC4]))
        count = int(np.prod(shape, dtype=np.int64))
        if count * dtype.itemsize != n:
            raise ValueError(f"an ndarray of shape {shape} and dtype {name} "
                             f"holds {n} bytes")
        return np.frombuffer(self.buf, dtype, count, offset).reshape(shape)


def loads(buf) -> Any:
    """Decode one msgpack object from a bytes-like `buf`. Array leaves are
    views of `buf` (read-only when `buf` is bytes)."""
    reader = _Reader(buf)
    tree = reader.read()
    if reader.pos != len(reader.mv):
        raise ValueError(f"{len(reader.mv) - reader.pos} bytes after the "
                         "msgpack object")
    return tree


def load(path: str) -> Any:
    """Read the file at `path` into one writable buffer and decode it; the
    array leaves are views of that buffer."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    view = memoryview(buf)
    with open(path, "rb", buffering=0) as f:
        done = 0
        while done < size:  # one read returns at most ~2 GiB on Linux
            n = f.readinto(view[done:])
            if not n:
                raise ValueError(f"{path}: file shrank while being read")
            done += n
    return loads(buf)
