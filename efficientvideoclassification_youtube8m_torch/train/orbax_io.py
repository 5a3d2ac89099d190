"""Orbax checkpoint directories without orbax, tensorstore or zarr (the
port's side of the JAX package's `--checkpoint_format orbax`).

The JAX package writes a checkpoint with
`orbax.checkpoint.StandardCheckpointer`: a directory `model.ckpt-<step>`
holding

  * `_METADATA`: JSON, the tree (`tree_metadata`: each leaf's key path
    with its key types, 2 a dict key and 1 a sequence index) and the
    layout (`use_ocdbt`, `use_zarr3`);
  * `_CHECKPOINT_METADATA`, `_sharding`, `array_metadatas/process_<i>`:
    JSON that a restore with a template does not need;
  * each leaf as a zarr v2 array named by its keys joined with "."
    (`params_student.rnn_l1.0.kernel`): a `.zarray` JSON and one chunk
    per grid cell (`0.0`, or `0` for a scalar), zstd-compressed by
    default.

By default (`use_ocdbt` true) the zarr keys live in an OCDBT store, the
key-value database of tensorstore: `manifest.ocdbt` and `d/<hash>` files
at the top, plus `ocdbt.process_<i>/` with a manifest and `d/` of its
own for each process that wrote. Its encoding, read from bytes with
tensorstore as the oracle:

  * a manifest or b-tree node is a frame: a big-endian u32 magic
    (0x0cdb3a2a manifest, 0x0cdb20de b-tree node), a little-endian u64
    length of the whole frame, varints version and compression (0 none,
    1 zstd), the body (one zstd frame when compressed) and a
    little-endian crc32c of everything before it;
  * integers in a body are LEB128 varints; a list of records is written
    field by field (all first fields, then all second fields, ...);
  * a manifest body: the config (a 16-byte uuid, varints manifest kind
    (0: one manifest file), max inline value bytes, max decoded node
    bytes, a byte version-tree arity log2, a varint compression method
    and, for zstd, an i32 level), a data-file table, the inline versions
    (generation, root height byte, root file index, offset, length,
    three statistics varints, a u64 commit time) and the references to
    older version-tree nodes, which a read of the latest version skips;
  * a data-file table: a count, then the prefix each path shares with
    the one before (for all but the first), each path's suffix length,
    each path's base-path length, then the suffixes; a file is
    `<base path><relative path>` under the store's directory (the
    top-level tree points into `ocdbt.process_<i>/d/`);
  * a b-tree node: a height byte, a data-file table, the entry count,
    the keys prefix-compressed as the paths are. A leaf (height 0) then
    has each value's length, its kind (0 inline, 1 in a data file), for
    the indirect ones their file index and offset, then the inline
    values back to back. An interior node has, after the key lengths,
    each entry's subtree common-prefix length (the part of its key that
    its subtree's keys leave out) before the key bytes, then each
    child's file index, offset and length, and three statistics.

Chunks and OCDBT bodies are zstd frames, decoded by the system's
`libzstd` through ctypes; without one a zstd chunk raises an error that
names it (`ZstdUnavailable`), never zeros. A chunk of the wrong size, an
unknown compressor or filter, a frame that fails its checksum or a
missing chunk raises `OrbaxFormatError`.

The writer (`write_orbax`) writes orbax's layout without OCDBT, as
`PyTreeCheckpointHandler(use_ocdbt=False)` does: one zarr v2 directory
per leaf with `"compressor": null` and one C-order chunk, which the JAX
package's `restore_checkpoint` and its template-less `inspect_checkpoint`
read. It writes no `_sharding`: orbax records there the device of each
jax.Array it saved, and a template-less restore on a host without that
device fails, while without the file it restores host arrays; a restore
with a template takes the template's shardings.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import shutil
import struct
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch.data.tfrecord import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
METADATA = "_METADATA"
_KEY_DICT, _KEY_SEQUENCE = 2, 1
# orbax's item handler as `StandardCheckpointer` records it
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
# zarr v2 dtype strings <-> numpy; "bfloat16" is a torch tensor here
_DTYPES = {f"{e}{c}{n}": np.dtype(f"{e}{c}{n}") for e in "<|" for c, sizes in
           (("f", (2, 4, 8)), ("i", (1, 2, 4, 8)), ("u", (1, 2, 4, 8)))
           for n in sizes}
_DTYPES["|b1"] = np.dtype(bool)
# the most bytes an OCDBT node decodes to (tensorstore's default limit is
# 100 MB)
_MAX_NODE_BYTES = 1 << 30


class OrbaxFormatError(ValueError):
    """The directory is not a checkpoint this reader can decode."""


class ZstdUnavailable(OrbaxFormatError):
    """A zstd-compressed chunk, and no zstd library to decode it."""


# ------------------------------------------------------------------ zstd

_ZSTD: Dict[str, Any] = {}


def zstd_library() -> Optional[str]:
    """The path or name of the `libzstd` that decodes zstd frames, None
    when there is none (then a zstd chunk raises `ZstdUnavailable`)."""
    if "lib" not in _ZSTD:
        _ZSTD["lib"] = _ZSTD["name"] = None
        for name in filter(None, (ctypes.util.find_library("zstd"), "libzstd.so.1")):
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_char_p, ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            _ZSTD["lib"], _ZSTD["name"] = lib, name
            break
    return _ZSTD["name"]


def zstd_decompress(data: bytes, where: str, size: Optional[int] = None) -> bytearray:
    """The decoded bytes of one or more zstd frames. `size`, when known,
    is the exact decoded size (a zarr chunk's); otherwise the output
    buffer grows until the frames fit, up to `_MAX_NODE_BYTES`. `where`
    names the file or key in every error."""
    if zstd_library() is None:
        raise ZstdUnavailable(f"{where}: zstd-compressed, and no libzstd was "
                              "found (ctypes.util.find_library('zstd'))")
    lib = _ZSTD["lib"]
    data = data if isinstance(data, bytes) else bytes(data)
    cap = size if size is not None else max(4 * len(data), 1 << 16)
    while True:
        out = bytearray(max(cap, 1))
        n = lib.ZSTD_decompress((ctypes.c_char * len(out)).from_buffer(out),
                                cap, data, len(data))
        if not lib.ZSTD_isError(n):
            if size is not None and n != size:
                raise OrbaxFormatError(f"{where}: decoded {n} bytes, the "
                                       f"array's chunk holds {size}")
            del out[n:]
            return out
        err = lib.ZSTD_getErrorName(n).decode()
        if size is None and "too small" in err and cap < _MAX_NODE_BYTES:
            cap *= 4
            continue
        raise OrbaxFormatError(f"{where}: zstd: {err}")


# ------------------------------------------------------------- OCDBT read

class _Reader:
    """A cursor over one decoded body."""

    def __init__(self, buf: bytes, where: str):
        self.buf, self.pos, self.where = buf, 0, where

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.buf):
                raise OrbaxFormatError(f"{self.where}: truncated varint")
            byte = self.buf[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OrbaxFormatError(f"{self.where}: truncated body")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise OrbaxFormatError(f"{self.where}: {len(self.buf) - self.pos} "
                                   "bytes left over after the last field")


def _frame(buf: bytes, magic: int, where: str) -> bytes:
    """The body of one manifest or b-tree node frame, its crc32c checked."""
    if len(buf) < 16:
        raise OrbaxFormatError(f"{where}: truncated frame")
    got, length = struct.unpack(">I", buf[:4])[0], struct.unpack("<Q", buf[4:12])[0]
    if got != magic:
        raise OrbaxFormatError(f"{where}: magic {got:08x}, expected {magic:08x}")
    if length != len(buf):
        raise OrbaxFormatError(f"{where}: frame of {len(buf)} bytes, its "
                               f"header says {length}")
    if struct.unpack("<I", buf[-4:])[0] != crc32c(buf[:-4]):
        raise OrbaxFormatError(f"{where}: crc32c mismatch")
    head = _Reader(buf[:-4], where)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0 or compression not in (0, 1):
        raise OrbaxFormatError(f"{where}: version {version}, compression "
                               f"{compression}")
    body = buf[head.pos:-4]
    return zstd_decompress(body, where) if compression == 1 else body


def _prefixed(r: _Reader, n: int, extra: bool = False
              ) -> Tuple[List[bytes], List[int]]:
    """`n` prefix-compressed byte strings (and, with `extra`, the list of
    varints written between their lengths and their bytes)."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    between = r.varints(n) if extra else []
    out, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.raw(s)
        out.append(prev)
    return out, between


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    paths, base = _prefixed(r, n, extra=True)
    del base  # base path + relative path: the same file under the store
    return [p.decode() for p in paths]


class _Ocdbt:
    """One OCDBT store (a directory with `manifest.ocdbt`): its keys at
    the latest version, each with the (file, offset, length) or inline
    bytes of its value."""

    def __init__(self, root: str):
        self.root = root
        self.entries: Dict[str, Any] = {}
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(_frame(f.read(), MANIFEST_MAGIC, path), path)
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise OrbaxFormatError(f"{path}: manifest kind {kind} (numbered "
                                   "manifests) is not read")
        r.varint(), r.varint()  # max inline value bytes, max decoded node bytes
        r.byte()  # version-tree arity log2
        if r.varint() == 1:
            r.raw(4)  # zstd level
        files = _file_table(r)
        n = r.varint()
        gens = r.varints(n)
        r.raw(n)  # root heights
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        if not n:
            return  # an empty store
        latest = max(range(n), key=gens.__getitem__)
        if lengths[latest]:  # an empty tree has no root node
            self._walk(files[fids[latest]], offsets[latest], lengths[latest], b"")

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            buf = f.read(length)
        if len(buf) != length:
            raise OrbaxFormatError(f"{path}: {length} bytes at {offset} asked, "
                                   f"{len(buf)} there")
        return buf

    def _walk(self, rel: str, offset: int, length: int, prefix: bytes) -> None:
        where = f"{os.path.join(self.root, rel)}@{offset}"
        r = _Reader(_frame(self._read(rel, offset, length), BTREE_MAGIC, where),
                    where)
        height = r.byte()
        files = _file_table(r)
        n = r.varint()
        if height == 0:
            keys, _ = _prefixed(r, n)
            sizes, kinds = r.varints(n), r.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise OrbaxFormatError(f"{where}: unknown value kind")
            fids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
            for i in range(n):
                if kinds[i] == 0:
                    self.entries[(prefix + keys[i]).decode()] = r.raw(sizes[i])
            for i, fid, off in zip(indirect, fids, offsets):
                self.entries[(prefix + keys[i]).decode()] = (files[fid], off, sizes[i])
            r.done()
            return
        keys, common = _prefixed(r, n, extra=True)
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics
        r.done()
        for key, c, fid, off, ln in zip(keys, common, fids, offsets, lengths):
            self._walk(files[fid], off, ln, prefix + key[:c])

    def get(self, key: str) -> Optional[bytes]:
        value = self.entries.get(key)
        if isinstance(value, tuple):
            return self._read(*value)
        return value


class _Store:
    """The zarr keys of a checkpoint directory: the OCDBT stores (the
    top-level one over those of `ocdbt.process_<i>/`, which a
    multi-process save leaves), or plain files without OCDBT."""

    def __init__(self, path: str, use_ocdbt: bool):
        self.path = path
        self.stores: List[_Ocdbt] = []
        if use_ocdbt:
            names = sorted(n for n in os.listdir(path) if n.startswith("ocdbt.process_"))
            roots = [os.path.join(path, n) for n in names]
            if os.path.exists(os.path.join(path, "manifest.ocdbt")):
                roots.insert(0, path)  # the merged tree wins
            for root in roots:
                if os.path.exists(os.path.join(root, "manifest.ocdbt")):
                    self.stores.append(_Ocdbt(root))
            if not self.stores:
                raise OrbaxFormatError(f"{path}: use_ocdbt, but no manifest.ocdbt")

    def where(self, key: str) -> str:
        return os.path.join(self.path, key)

    def get(self, key: str) -> Optional[bytes]:
        if not self.stores:
            try:
                with open(self.where(key), "rb") as f:
                    buf = bytearray(os.fstat(f.fileno()).st_size)
                    f.readinto(buf)  # writable: arrays are views of it
                    return buf
            except FileNotFoundError:
                return None
        for store in self.stores:
            if key in store.entries:
                return store.get(key)
        return None


# -------------------------------------------------------------- zarr read

def _chunk_keys(grid: Tuple[int, ...], sep: str) -> Iterator[Tuple[Tuple[int, ...], str]]:
    for idx in np.ndindex(*grid) if grid else [()]:
        yield idx, sep.join(map(str, idx)) if idx else "0"


def read_array(store: _Store, name: str):
    """The zarr v2 array `name` of `store`: a numpy array, or a torch
    bfloat16 tensor for dtype "bfloat16"."""
    meta_raw = store.get(f"{name}/.zarray")
    if meta_raw is None:
        raise OrbaxFormatError(f"{store.where(name)}: no .zarray")
    meta = json.loads(meta_raw)
    where = store.where(name)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{where}: zarr_format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{where}: filters {meta['filters']} are not read")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{where}: order {meta['order']} is not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {compressor} is not read "
                               "(zstd or none)")
    bf16 = meta["dtype"] == "bfloat16"
    if not bf16 and meta["dtype"] not in _DTYPES:
        raise OrbaxFormatError(f"{where}: dtype {meta['dtype']} is not read")
    dtype = np.dtype("<u2") if bf16 else _DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    grid = tuple(-(-s // c) for s, c in zip(shape, chunks))
    out = None if grid == (1,) * len(shape) and chunks == shape else np.empty(shape, dtype)
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx, key in _chunk_keys(grid, meta.get("dimension_separator", ".")):
        raw = store.get(f"{name}/{key}")
        if raw is None:
            raise OrbaxFormatError(f"{where}/{key}: missing chunk")
        if compressor is not None:
            raw = zstd_decompress(raw, f"{where}/{key}", size=nbytes)
        elif len(raw) != nbytes:
            raise OrbaxFormatError(f"{where}/{key}: {len(raw)} bytes, the "
                                   f"chunk holds {nbytes}")
        block = np.frombuffer(raw, dtype).reshape(chunks)
        if out is None:  # the whole array in one chunk
            out = block if block.flags.writeable else block.copy()
            break
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if out is None:  # an empty grid
        out = np.empty(shape, dtype)
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# -------------------------------------------------------------- the tree

def _metadata(path: str) -> dict:
    meta_path = os.path.join(path, METADATA)
    if not os.path.isdir(path) or not os.path.exists(meta_path):
        raise OrbaxFormatError(f"{path}: not an orbax checkpoint (no {METADATA})")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: zarr3 arrays are not read")
    return meta


def read_orbax(path: str, fields=None, sequences: bool = False) -> dict:
    """The tree of the orbax checkpoint directory `path`, its leaves numpy
    arrays (torch bfloat16 tensors for bfloat16 leaves). Dict keys and
    sequence indices are strings, as in a msgpack checkpoint's state
    dict; with `sequences` a sequence is a list, as orbax restores it
    without a template. `fields` restricts the read to those top-level
    keys."""
    meta = _metadata(path)
    store = _Store(path, bool(meta.get("use_ocdbt", True)))
    tree: dict = {}
    kinds: Dict[Tuple[str, ...], int] = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        names = tuple(str(k["key"]) for k in keys)
        if fields is not None and names[0] not in fields:
            continue
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize"):
            continue
        node = tree
        for depth, key in enumerate(keys[:-1]):
            kinds[names[:depth + 1]] = keys[depth + 1]["key_type"]
            node = node.setdefault(str(key["key"]), {})
        node[names[-1]] = read_array(store, ".".join(names))
    if not sequences:
        return tree

    def listify(node, prefix):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v, prefix + (k,)) for k, v in node.items()}
        if kinds.get(prefix) == _KEY_SEQUENCE:
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree, ())


# ----------------------------------------------------------------- write

def _flatten(tree: Any, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...], Any]]:
    """(keys, key types, leaf) of each leaf; a dict whose keys are "0" ...
    "n-1" (a sequence in a msgpack state dict) gets sequence key types."""
    if not isinstance(tree, dict):
        yield (), (), tree
        return
    seq = bool(tree) and sorted(tree, key=str) == sorted(map(str, range(len(tree))))
    for key, value in tree.items():
        for keys, types, leaf in _flatten(value):
            yield ((str(key),) + keys,
                   (_KEY_SEQUENCE if seq else _KEY_DICT,) + types, leaf)


def _zarr_array(leaf) -> Tuple[str, np.ndarray]:
    """The zarr dtype string of a leaf and its C-order little-endian
    array (the leaf itself where it is one already: no copy)."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        arr = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        return "bfloat16", np.ascontiguousarray(arr.astype("<i2", copy=False))
    arr = np.asarray(leaf)
    dt = arr.dtype.newbyteorder("<") if arr.dtype.itemsize > 1 else arr.dtype
    code = dt.str if arr.dtype != bool else "|b1"
    if code not in _DTYPES:
        raise TypeError(f"cannot write a {arr.dtype} leaf to an orbax checkpoint")
    arr = arr.astype(dt, copy=False)
    return code, arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def write_orbax(path: str, tree: dict,
                default: Optional[Callable[[Any], Any]] = None) -> str:
    """Write `tree` (nested dicts; leaves numpy arrays, scalars, or
    whatever `default` turns into one) as the orbax checkpoint directory
    `path`, in orbax's layout without OCDBT, through a temporary
    directory and `os.replace` (a stale `path` is removed first).
    Returns `path`."""
    start = time.time_ns()
    parent = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(parent, f".{os.path.basename(path)}.orbax-tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_meta, arrays = {}, []
    for keys, types, leaf in _flatten(tree):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        if default is not None and not bf16 and not isinstance(leaf, (np.ndarray, np.generic)):
            leaf = default(leaf)
        code, arr = _zarr_array(leaf)
        shape = arr.shape
        name = ".".join(keys)
        os.makedirs(os.path.join(tmp, name))
        with open(os.path.join(tmp, name, ".zarray"), "w") as f:
            json.dump({"chunks": list(shape), "compressor": None,
                       "dimension_separator": ".", "dtype": code,
                       "fill_value": None, "filters": None, "order": "C",
                       "shape": list(shape), "zarr_format": 2},
                      f, separators=(",", ":"))
        with open(os.path.join(tmp, name, ".".join("0" * len(shape)) or "0"),
                  "wb") as f:
            f.write(arr.reshape(-1).view(np.uint8).data)
        tree_meta[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in zip(keys, types)],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": list(shape)}}
        arrays.append({"array_metadata": {"param_name": name,
                                          "write_shape": list(shape),
                                          "chunk_shape": list(shape),
                                          "ext_metadata": None}})
    with open(os.path.join(tmp, METADATA), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    os.makedirs(os.path.join(tmp, "array_metadatas"))
    with open(os.path.join(tmp, "array_metadatas", "process_0"), "w") as f:
        json.dump({"array_metadatas": arrays}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": start,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path
