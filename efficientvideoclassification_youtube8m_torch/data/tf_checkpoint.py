"""Pure-Python reader for TensorFlow Saver V2 checkpoints (the reader of
the JAX package's data/tf_checkpoint.py; its writer comes with the
checkpoint interop item of the ROADMAP, which is what needs it).

The reference framework's artifacts are TF-V2 checkpoint bundles — a
`<prefix>.index` file (an immutable LevelDB-style table mapping tensor
names to entries) plus `<prefix>.data-NNNNN-of-NNNNN` shard files with
the raw tensor bytes. The reference reads them with `tf.train.Saver`
and hardcoded var-name maps
(`validate.py:350-381`,
`inspect_checkpoint_myfile.py:21-34`); this module reads the same files
with no TensorFlow dependency, in the same spirit as the framework's
own TFRecord/proto codecs (`data/tfrecord.py`, `data/proto.py`).

Format, outermost-in:

  * `.index` is a LevelDB *table*: prefix-compressed key/value blocks,
    an index block locating them, and a fixed 48-byte footer
    (two varint64 BlockHandles + padding + magic 0xdb4775248b80fb57).
  * key ""        -> BundleHeaderProto  (num_shards, endianness)
  * key "<name>"  -> BundleEntryProto   (dtype, shape, shard_id, offset,
                                         size, masked crc32c)
  * tensor bytes live at [offset, offset+size) of the shard_id'th
    `.data-*` file, little-endian, C order.
"""

from __future__ import annotations

import glob as globlib
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from efficientvideoclassification_youtube8m_torch.data.proto import (
    iter_fields,
    read_varint,
)
from efficientvideoclassification_youtube8m_torch.data.tfrecord import (
    crc32c,
    unmask_crc32c,
)

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_SIZE = 48
_BLOCK_TRAILER_SIZE = 5  # 1-byte compression type + 4-byte crc32c

# TF DataType enum -> numpy dtype (framework_dtypes; the subset a YT8M
# checkpoint can contain)
_DTYPES = {
    1: np.dtype("<f4"),   # DT_FLOAT
    2: np.dtype("<f8"),   # DT_DOUBLE
    3: np.dtype("<i4"),   # DT_INT32
    4: np.dtype("<u1"),   # DT_UINT8
    5: np.dtype("<i2"),   # DT_INT16
    6: np.dtype("<i1"),   # DT_INT8
    9: np.dtype("<i8"),   # DT_INT64
    10: np.dtype("bool"),  # DT_BOOL
    14: np.dtype("<u2"),  # DT_BFLOAT16 (raw bits; converted on load)
    19: np.dtype("<f2"),  # DT_HALF
    22: np.dtype("<u4"),  # DT_UINT32
    23: np.dtype("<u8"),  # DT_UINT64
}


class BundleEntry:
    """One tensor's index record (BundleEntryProto)."""

    __slots__ = ("name", "dtype_code", "shape", "shard_id", "offset",
                 "size", "crc32c", "sliced")

    def __init__(self, name: str):
        self.name = name
        self.dtype_code = 0
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c: Optional[int] = None
        self.sliced = False

    @property
    def dtype(self) -> np.dtype:
        if self.dtype_code not in _DTYPES:
            raise ValueError(
                f"unsupported dtype code {self.dtype_code} for {self.name!r}"
            )
        return _DTYPES[self.dtype_code]

    def __repr__(self):
        return (f"BundleEntry({self.name!r}, dtype={self.dtype_code}, "
                f"shape={self.shape}, shard={self.shard_id}, "
                f"offset={self.offset}, size={self.size})")


# ---------------------------------------------------------------------------
# LevelDB table plumbing
# ---------------------------------------------------------------------------


def _read_block_handle(buf: bytes, pos: int) -> Tuple[int, int, int]:
    offset, pos = read_varint(buf, pos)
    size, pos = read_varint(buf, pos)
    return offset, size, pos


def _snappy_decompress(data: memoryview) -> bytes:
    """Minimal raw-snappy decoder (LevelDB block compression). TF writes
    checkpoint tables uncompressed by default; this covers non-default
    builds so the reader never needs a snappy package."""
    buf = bytes(data)
    out_len, pos = read_varint(buf, 0)
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(buf[pos:pos + extra], "little") + 1
                pos += extra
            out += buf[pos:pos + length]
            pos += length
        else:
            if kind == 1:  # copy, 1-byte offset
                length = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:  # copy, 2-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos:pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos:pos + 4], "little")
                pos += 4
            start = len(out) - offset
            for i in range(length):  # may self-overlap; byte-at-a-time
                out.append(out[start + i])
    if len(out) != out_len:
        raise ValueError("snappy decode length mismatch")
    return bytes(out)


def _read_block(data: memoryview, offset: int, size: int) -> bytes:
    """Fetch a table block, verify its trailer crc, decompress if needed."""
    raw = data[offset:offset + size]
    trailer = data[offset + size:offset + size + _BLOCK_TRAILER_SIZE]
    compression = trailer[0]
    stored_crc = struct.unpack("<I", trailer[1:5])[0]
    actual = crc32c(bytes(raw) + bytes([compression]))
    if unmask_crc32c(stored_crc) != actual:
        raise ValueError("table block crc mismatch (corrupt .index file)")
    if compression == 0:
        return bytes(raw)
    if compression == 1:
        return _snappy_decompress(raw)
    raise ValueError(f"unknown block compression type {compression}")


def _iter_block_entries(block: bytes):
    """Yield (key, value) over a prefix-compressed table block."""
    if len(block) < 4:
        return
    num_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = read_varint(block, pos)
        non_shared, pos = read_varint(block, pos)
        value_len, pos = read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _parse_shape(buf) -> Tuple[Tuple[int, ...], bool]:
    """TensorShapeProto -> (dims, unknown_rank)."""
    dims: List[int] = []
    unknown = False
    for fnum, _, val in iter_fields(bytes(buf)):
        if fnum == 2:  # Dim
            for dnum, _, dval in iter_fields(bytes(val)):
                if dnum == 1:
                    # int64 varint; negative sizes arrive two's-complement
                    if dval >= 1 << 63:
                        dval -= 1 << 64
                    dims.append(int(dval))
        elif fnum == 3:
            unknown = bool(val)
    return tuple(dims), unknown


def _parse_entry(name: str, buf: bytes) -> BundleEntry:
    e = BundleEntry(name)
    for fnum, wt, val in iter_fields(buf):
        if fnum == 1:
            e.dtype_code = int(val)
        elif fnum == 2:
            e.shape, _ = _parse_shape(val)
        elif fnum == 3:
            e.shard_id = int(val)
        elif fnum == 4:
            e.offset = int(val)
        elif fnum == 5:
            e.size = int(val)
        elif fnum == 6:
            e.crc32c = struct.unpack("<I", bytes(val))[0]
        elif fnum == 7:
            e.sliced = True
    return e


class TFCheckpointReader:
    """Random-access reader over one V2 checkpoint bundle."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index_path = prefix + ".index"
        if not os.path.exists(index_path):
            raise IOError(f"not a TF V2 checkpoint: {index_path} missing")
        with open(index_path, "rb") as f:
            table = f.read()
        if len(table) < _FOOTER_SIZE:
            raise ValueError(f"{index_path}: truncated table")
        footer = table[-_FOOTER_SIZE:]
        magic = struct.unpack("<Q", footer[-8:])[0]
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{index_path}: bad table magic {magic:#x}")
        pos = 0
        _, _, pos = _read_block_handle(footer, pos)  # metaindex (unused)
        index_off, index_size, _ = _read_block_handle(footer, pos)

        view = memoryview(table)
        self._entries: Dict[str, BundleEntry] = {}
        self.num_shards = 1
        index_block = _read_block(view, index_off, index_size)
        for _, handle in _iter_block_entries(index_block):
            off, size, _ = _read_block_handle(handle, 0)
            for key, value in _iter_block_entries(_read_block(view, off, size)):
                name = key.decode("utf-8")
                if name == "":
                    # BundleHeaderProto: field 1 num_shards
                    for fnum, _, val in iter_fields(value):
                        if fnum == 1:
                            self.num_shards = int(val)
                else:
                    self._entries[name] = _parse_entry(name, value)
        self._shard_cache: Dict[int, np.memmap] = {}

    # ------------------------------------------------------------------
    def variable_names(self) -> List[str]:
        return sorted(self._entries)

    def list_variables(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """(name, shape, dtype-name) for every tensor, index-only (no
        tensor bytes are read) — what `inspect_checkpoint` prints."""
        out = []
        for name in self.variable_names():
            e = self._entries[name]
            try:
                dt = e.dtype.name if e.dtype_code != 14 else "bfloat16"
            except ValueError:
                dt = f"dtype_{e.dtype_code}"
            out.append((name, e.shape, dt))
        return out

    def has_tensor(self, name: str) -> bool:
        return name in self._entries

    def _shard_bytes(self, shard_id: int) -> np.memmap:
        if shard_id not in self._shard_cache:
            path = (
                f"{self.prefix}.data-{shard_id:05d}-of-{self.num_shards:05d}"
            )
            self._shard_cache[shard_id] = np.memmap(path, np.uint8, "r")
        return self._shard_cache[shard_id]

    def get_tensor(self, name: str) -> np.ndarray:
        e = self._entries.get(name)
        if e is None:
            raise KeyError(f"{name!r} not in checkpoint {self.prefix}")
        if e.sliced:
            raise NotImplementedError(
                f"{name!r} is a partitioned variable; the reference never "
                "writes slices"
            )
        raw = self._shard_bytes(e.shard_id)[e.offset:e.offset + e.size]
        raw = raw.tobytes()
        if e.crc32c is not None and unmask_crc32c(e.crc32c) != crc32c(raw):
            raise ValueError(f"tensor {name!r}: crc mismatch (corrupt data)")
        if e.dtype_code == 7:  # DT_STRING: varint-length-prefixed strings
            raise NotImplementedError("string tensors are not supported")
        arr = np.frombuffer(raw, e.dtype)
        if e.dtype_code == 14:  # bfloat16 bits -> float32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.reshape(e.shape)

    def read_all(self) -> Dict[str, np.ndarray]:
        return {n: self.get_tensor(n) for n in self.variable_names()}


def is_tf_checkpoint(prefix: str) -> bool:
    """True if `prefix` names a TF V2 bundle (prefix or its .index)."""
    if prefix.endswith(".index"):
        prefix = prefix[: -len(".index")]
    return os.path.exists(prefix + ".index")


def latest_tf_checkpoint(train_dir: str) -> Optional[str]:
    """Newest `model.ckpt-N` bundle prefix in a reference train_dir."""
    candidates = globlib.glob(os.path.join(train_dir, "*.index"))
    best, best_step = None, -1
    for c in candidates:
        stem = os.path.basename(c)[: -len(".index")]
        step = stem.rsplit("-", 1)[-1]
        if step.isdigit() and int(step) > best_step:
            best, best_step = c[: -len(".index")], int(step)
    return best
