"""TFRecord container format: reader + writer + CRC32C.

The on-disk framing (public format) per record:

    uint64  length            (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   data[length]
    uint32  masked_crc32c(data)

mask(crc) = ((crc >> 15) | (crc << 17)) + 0xa282ead8  (mod 2^32).

CRC32C (Castagnoli, reflected poly 0x82F63B78) is table-driven here; the
C++ loader (data/native) uses the same algorithm with a sliced table.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

import numpy as np

_MASK_DELTA = 0xA282EAD8


def _make_crc32c_table() -> np.ndarray:
    poly = 0x82F63B78
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_crc32c_table()
# 4-level table for vectorized numpy crc (slice-by-1 is too slow in pure py)
_TABLES = [_TABLE]
for _ in range(3):
    prev = _TABLES[-1]
    _TABLES.append((prev >> 8) ^ _TABLE[prev & 0xFF])


_NATIVE_CRC = [False, None]  # (resolved?, fn-or-None)


def _native_crc():
    """The C slice-by-8 CRC32C (data/native, ~1.1 GB/s vs ~1.3 MB/s for
    the table loop below) — resolved lazily to dodge the import cycle
    and fall back cleanly without a compiler."""
    if not _NATIVE_CRC[0]:
        fn = None
        try:
            from efficientvideoclassification_youtube8m_torch.data import native

            if native.available():
                fn = native.crc32c
        except ImportError:
            pass
        _NATIVE_CRC[:] = [True, fn]
    return _NATIVE_CRC[1]


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C; the C kernel when built, numpy tables otherwise. `crc`
    continues from a finalized value (incremental use) on both paths."""
    native = _native_crc()
    if native is not None:
        return native(data, crc)
    crc = (~crc) & 0xFFFFFFFF
    buf = np.frombuffer(data, dtype=np.uint8)
    n4 = len(buf) // 4
    if n4:
        words = buf[: n4 * 4].view("<u4").astype(np.uint32)
        t0, t1, t2, t3 = _TABLES
        c = np.uint32(crc)
        for w in words:
            x = np.uint32(w ^ c)
            c = (
                t3[x & 0xFF]
                ^ t2[(x >> np.uint32(8)) & 0xFF]
                ^ t1[(x >> np.uint32(16)) & 0xFF]
                ^ t0[(x >> np.uint32(24)) & 0xFF]
            )
        crc = int(c)
    for b in buf[n4 * 4 :]:
        crc = (crc >> 8) ^ int(_TABLE[(crc ^ int(b)) & 0xFF])
    return (~crc) & 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask_crc32c(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


class TFRecordReader:
    """Iterates serialized records from a TFRecord file."""

    def __init__(self, path: str, verify_crc: bool = False):
        self.path = path
        self.verify_crc = verify_crc

    def __iter__(self) -> Iterator[bytes]:
        with open(self.path, "rb") as f:
            while True:
                header = f.read(12)
                if len(header) == 0:
                    return
                if len(header) < 12:
                    raise IOError(f"truncated TFRecord header in {self.path}")
                (length,) = struct.unpack("<Q", header[:8])
                (len_crc,) = struct.unpack("<I", header[8:12])
                if self.verify_crc and masked_crc32c(header[:8]) != len_crc:
                    raise IOError(f"corrupt length crc in {self.path}")
                data = f.read(length)
                if len(data) < length:
                    raise IOError(f"truncated TFRecord data in {self.path}")
                footer = f.read(4)
                if len(footer) < 4:
                    raise IOError(f"truncated TFRecord footer in {self.path}")
                if self.verify_crc:
                    (data_crc,) = struct.unpack("<I", footer)
                    if masked_crc32c(data) != data_crc:
                        raise IOError(f"corrupt data crc in {self.path}")
                yield data


class TFRecordWriter:
    """Writes TF-compatible records (used for fixtures and synthetic data)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
