"""The benchmark's one traffic generator, driven by the files under
`portbench/traffic/`.

Every seed gets the same set of sizes in another order: the video
lengths are the quantiles of the traffic's uniform range of seconds (one
frame a second, capped at `max_frames`), permuted by the seed, and the
open loop's gaps are the quantiles of an exponential distribution at the
traffic's rate, permuted by the seed. The features (uint8, uniform) and
the labels (a Poisson count with the traffic's mean, at least one,
distinct classes) are drawn from the seed.

A "pool" traffic is written as TFRecord shards of YouTube-8M frame-level
SequenceExamples, the records byte for byte what the public format
holds, by a frozen writer of this module (the protobuf framing and the
TFRecord CRC32C), into a cache directory keyed by the cell and the seed.
An "open_loop" traffic is a pool of requests held in memory and a
schedule of due times.
"""

from __future__ import annotations

import shutil
import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_POOLS_KEPT = 4


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each use of the seed."""
    return np.random.default_rng([stream, seed])


def lengths(n: int, seconds: Sequence[float], max_frames: int,
            seed: int) -> np.ndarray:
    """n video lengths in frames: the uniform quantiles of `seconds`
    (lo, hi), one frame a second, capped at `max_frames`, in the seed's
    order."""
    lo, hi = seconds
    q = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    frames = np.minimum(np.floor(q).astype(np.int64), max_frames)
    return rng(seed, 1).permutation(frames).astype(np.int32)


def labels(n: int, vocab: int, mean: float, seed: int) -> List[np.ndarray]:
    """Each video's sorted distinct classes: a Poisson count of mean
    `mean`, at least one."""
    g = rng(seed, 2)
    counts = np.maximum(g.poisson(mean, size=n), 1)
    return [np.sort(g.choice(vocab, size=int(c), replace=False)) for c in counts]


def features(nf: np.ndarray, width: int, seed: int, max_frames: int,
             device: str = "cpu") -> np.ndarray:
    """[n, max_frames, width] uint8: uniform bytes in each video's first
    nf frames, zeros after; drawn by a torch generator on `device`."""
    g = torch.Generator(device).manual_seed(seed & (2 ** 63 - 1))
    out = torch.randint(0, 256, (len(nf), max_frames, width), generator=g,
                        dtype=torch.uint8, device=device)
    frame = torch.arange(max_frames, device=device)[None, :]
    out[frame >= torch.as_tensor(nf, device=device)[:, None]] = 0
    return out.cpu().numpy()


# ------------------------------------------------ protobuf and TFRecord


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _bytes_feature(value: bytes) -> bytes:
    # Feature { bytes_list = 1: BytesList { value = 1 } }
    return _field(1, _field(1, value))


def _int64_feature(values) -> bytes:
    packed = b"".join(_varint(int(v) & ((1 << 64) - 1)) for v in values)
    return _field(3, _field(1, packed))


def _map_entry(key: str, value: bytes) -> bytes:
    return _field(1, _field(1, key.encode()) + _field(2, value))


def frame_record(video_id: str, classes, frames: np.ndarray,
                 names: Sequence[str], sizes: Sequence[int]) -> bytes:
    """A SequenceExample: context {id, labels}, and one feature list a
    name, one bytes Feature a frame. `frames` is [num_frames, sum(sizes)]
    uint8."""
    context = (_map_entry("id", _bytes_feature(video_id.encode()))
               + _map_entry("labels", _int64_feature(classes)))
    lists = b""
    off = 0
    for name, size in zip(names, sizes):
        n = frames.shape[0]
        # every frame's Feature has the same prefix: build them as rows
        prefix = np.frombuffer(
            _field(1, _field(1, _field(1, b"\0" * size)))[:-size], np.uint8)
        rows = np.empty((n, prefix.size + size), np.uint8)
        rows[:, :prefix.size] = prefix
        rows[:, prefix.size:] = frames[:, off:off + size]
        lists += _map_entry(name, rows.tobytes())
        off += size
    return _field(1, context) + _field(2, lists)


def _crc_tables() -> List[np.ndarray]:
    """CRC32C (Castagnoli, reflected) byte tables for 0-3 further bytes."""
    table = np.zeros(256, np.int64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table[i] = c
    tables = [table]
    for _ in range(3):
        tables.append((tables[-1] >> 8) ^ table[tables[-1] & 0xFF])
    return tables


_TABLES = _crc_tables()


def _zero_operator(n: int) -> np.ndarray:
    """[4, 256] byte tables of the register map of n zero bytes (linear
    over GF(2)): Z(r) = xor over j of tables[j][byte j of r]."""
    r = (np.arange(256, dtype=np.int64)[None, :]
         << (8 * np.arange(4, dtype=np.int64))[:, None]).reshape(-1)
    for _ in range(n):
        r = (r >> 8) ^ _TABLES[0][r & 0xFF]
    return r.reshape(4, 256)


def _lookup(tables, r):
    return (tables[0][r & 0xFF] ^ tables[1][(r >> 8) & 0xFF]
            ^ tables[2][(r >> 16) & 0xFF] ^ tables[3][(r >> 24) & 0xFF])


def crc32c_many(messages: Sequence[bytes], segment: int = 1024,
                device: str = "cpu") -> np.ndarray:
    """The CRC32C of each message, all at once on `device`: each message
    (its first 4 bytes xored with the initial 0xFFFFFFFF, which a
    reflected CRC allows) is left-padded with zeros, which leave a zero
    register unchanged, to a common multiple of `segment`; every
    segment's register is computed in parallel, 4 bytes a step, and the
    segments are joined through the map of `segment` zero bytes."""
    n = len(messages)
    longest = max(max(len(m) for m in messages), 4)
    length = -(-longest // segment) * segment
    buf = np.zeros((n, length), np.uint8)
    for i, m in enumerate(messages):
        row = buf[i, length - len(m):]
        row[:] = np.frombuffer(m, np.uint8)
        row[:4] ^= 0xFF
    words = torch.from_numpy(buf.view("<u4").astype(np.int64)).to(device)
    words = words.reshape(n * (length // segment), segment // 4)
    step = [torch.from_numpy(t).to(device) for t in reversed(_TABLES)]
    r = torch.zeros(words.shape[0], dtype=torch.int64, device=device)
    for k in range(words.shape[1]):
        r = _lookup(step, r ^ words[:, k])
    r = r.reshape(n, length // segment)
    zero = torch.from_numpy(_zero_operator(segment)).to(device)
    acc = torch.zeros(n, dtype=torch.int64, device=device)
    for k in range(r.shape[1]):
        acc = _lookup(zero, acc) ^ r[:, k]
    return (acc.cpu().numpy() ^ 0xFFFFFFFF).astype(np.uint32)


def masked(crc: np.ndarray) -> np.ndarray:
    crc = crc.astype(np.uint64)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF).astype(np.uint32)


def write_tfrecords(path: Path, records: Sequence[bytes],
                    device: str = "cpu") -> None:
    """TFRecord framing: u64 length, its masked CRC32C, the data, the
    data's masked CRC32C."""
    heads = [struct.pack("<Q", len(r)) for r in records]
    crcs = masked(np.concatenate([crc32c_many(heads, 8, device),
                                  crc32c_many(records, 1024, device)]))
    n = len(records)
    with open(path, "wb") as f:
        for i, r in enumerate(records):
            f.write(heads[i] + struct.pack("<I", int(crcs[i])) + r
                    + struct.pack("<I", int(crcs[n + i])))


# --------------------------------------------------------- the traffic


def pool(traffic: Dict, cfg: Dict, seed: int, device: str = "cpu") -> Dict:
    """The pool's videos as arrays: num_frames [n], features [n,
    max_frames, width] uint8, labels (a list of class arrays)."""
    n = traffic["videos"]
    max_frames = cfg["max_num_frames"]
    nf = lengths(n, traffic["seconds"], max_frames, seed)
    width = sum(int(s) for s in str(cfg["feature_sizes"]).split(","))
    return {"num_frames": nf,
            "features": features(nf, width, seed, max_frames, device),
            "labels": labels(n, cfg["num_classes"], traffic["mean_labels"], seed)}


def video_id(seed: int, i: int) -> str:
    """The id the pool's shards give video i."""
    return f"pb{seed}_{i:05d}"


def video_index(vid: str) -> int:
    """The pool index of a video id that `video_id` made."""
    return int(vid.rsplit("_", 1)[1])


def dense_labels(classes: Sequence[np.ndarray], vocab: int) -> np.ndarray:
    """[n, vocab] bool from each video's classes."""
    out = np.zeros((len(classes), vocab), bool)
    for r, c in enumerate(classes):
        out[r, c] = True
    return out


def _names_sizes(cfg: Dict) -> Tuple[List[str], List[int]]:
    names = [s.strip() for s in str(cfg["feature_names"]).split(",")]
    sizes = [int(s) for s in str(cfg["feature_sizes"]).split(",")]
    return names, sizes


def write_pool(directory: Path, traffic: Dict, cfg: Dict, seed: int,
               device: str = "cpu") -> str:
    """Write the pool's shards into `directory` (once: a finished pool is
    marked by a `done` file) and return their glob pattern."""
    pattern = str(directory / "pool-*.tfrecord")
    if (directory / "done").exists():
        return pattern
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    videos = pool(traffic, cfg, seed, device)
    names, sizes = _names_sizes(cfg)
    shards = traffic["shards"]
    n = len(videos["num_frames"])
    for s in range(shards):
        records = [frame_record(video_id(seed, i), videos["labels"][i],
                                videos["features"][i, :videos["num_frames"][i]],
                                names, sizes)
                   for i in range(s, n, shards)]
        write_tfrecords(directory / f"pool-{s:04d}-of-{shards:04d}.tfrecord",
                        records, device)
    (directory / "done").write_text("")
    _prune(directory.parent)
    return pattern


def _prune(pools: Path) -> None:
    """Keep the newest pools only: every seed writes its own."""
    done = sorted((p for p in pools.iterdir() if (p / "done").exists()),
                  key=lambda p: (p / "done").stat().st_mtime, reverse=True)
    for old in done[_POOLS_KEPT:]:
        shutil.rmtree(old, ignore_errors=True)


def schedule(traffic: Dict, seconds: float, seed: int) -> np.ndarray:
    """Open-loop due times (seconds from the window's start) of the
    requests of a window: rate x seconds gaps, the quantiles of the
    exponential distribution at the traffic's rate, in the seed's order."""
    rate = float(traffic["rate"])
    n = max(1, int(round(rate * seconds)))
    gaps = rng(seed, 4).permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def requests(traffic: Dict, cfg: Dict, seed: int, device: str = "cpu") -> Dict:
    """The open loop's request pool: `requests` requests of
    `request_videos` videos each, as [R, V, max_frames, width] uint8 and
    num_frames [R, V]."""
    r, v = traffic["requests"], traffic["request_videos"]
    videos = pool(dict(traffic, videos=r * v), cfg, seed, device)
    shape = videos["features"].shape
    return {"features": videos["features"].reshape(r, v, *shape[1:]),
            "num_frames": videos["num_frames"].reshape(r, v)}


def cache_dir(root: Path, cell: str, seed: int) -> Path:
    return root / "build" / "portbench" / "pools" / f"{cell}-{seed}"
