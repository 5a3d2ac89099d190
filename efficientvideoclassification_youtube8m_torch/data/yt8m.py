"""YT8M dataset records: parse + synthesize.

Mirrors the two readers of `readers.py`:

  * frame-level (`YT8MFrameFeatureReader:114-246`): SequenceExample with
    context {id: bytes, labels: int64 list} and per-frame byte-string
    features (one uint8-quantized vector per frame per feature name).
  * video-level (`YT8MAggregatedFeatureReader:53-112`): Example with
    {id, labels} plus fixed-length float feature vectors.

Device-first difference: the frame features stay **uint8** all the way to
the device; dequantize/normalize run inside the step
(ops/preprocess.py). Padding/truncation to max_frames happens on the
host into preallocated batch buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from efficientvideoclassification_youtube8m_torch.data import proto
from efficientvideoclassification_youtube8m_torch.data.tfrecord import (
    TFRecordReader,
    TFRecordWriter,
)


@dataclasses.dataclass
class FrameVideo:
    """One parsed frame-level video record."""

    video_id: str
    labels: List[int]
    features: np.ndarray  # [num_frames(<=max), total_feature_size] uint8
    num_frames: int  # min(true frames, max_frames)
    # True when `features` is already zero-padded to its full row count
    # ([max_frames, total], or [ceil(max_frames/stride), total] strided)
    # (the native parser's output) — lets the batch assembler copy one
    # contiguous block instead of memset + row-slice copy
    padded: bool = False


def parse_frame_record(
    record: bytes,
    feature_names: Sequence[str] = ("rgb", "audio"),
    feature_sizes: Sequence[int] = (1024, 128),
    max_frames: int = 300,
) -> FrameVideo:
    """SequenceExample -> FrameVideo (uint8 features, concatenated)."""
    context, feature_lists = proto.decode_sequence_example(record)

    kind, vals = context.get("id", ("bytes", [b""]))
    # errors="replace" like the native parser: a corrupt id must not
    # kill the epoch on one path while the other continues
    video_id = vals[0].decode("utf-8", "replace") if vals else ""
    _, label_vals = context.get("labels", ("int64", []))
    labels = [int(v) for v in label_vals]

    mats = []
    num_frames = -1
    for name, size in zip(feature_names, feature_sizes):
        frames = feature_lists.get(name, [])
        # each frame: a Feature with one bytes value of length `size`
        # (first value only, like the native parser). Validate EVERY
        # frame's payload length — a wrong-length frame whose total
        # still divides by `size` would otherwise silently shift all
        # later frames' columns in the reshape below, while the native
        # parser (yt8m_io.cc "frame feature size mismatch") raises.
        for f in frames:
            if not f[1] or len(f[1][0]) != size:
                raise ValueError(
                    f"frame feature size mismatch: {name!r} frame has "
                    f"{len(f[1][0]) if f[1] else 0} bytes, expected {size}"
                )
        raw = b"".join(f[1][0] for f in frames)
        mat = np.frombuffer(raw, dtype=np.uint8).reshape(-1, size)
        if num_frames == -1:
            num_frames = mat.shape[0]
        elif num_frames != mat.shape[0]:
            raise ValueError(
                f"feature {name} has {mat.shape[0]} frames, expected {num_frames}"
            )
        mats.append(mat[:max_frames])
    num_frames = min(num_frames, max_frames)
    features = np.concatenate(mats, axis=1) if mats else np.zeros((0, 0), np.uint8)
    return FrameVideo(video_id, labels, features, num_frames)


def encode_frame_record(
    video_id: str,
    labels: Sequence[int],
    features: np.ndarray,  # [num_frames, total_size] uint8
    feature_names: Sequence[str] = ("rgb", "audio"),
    feature_sizes: Sequence[int] = (1024, 128),
) -> bytes:
    """FrameVideo -> serialized SequenceExample (fixtures / synthetic data)."""
    context = {
        "id": ("bytes", [video_id.encode("utf-8")]),
        "labels": ("int64", list(labels)),
    }
    feature_lists = {}
    off = 0
    for name, size in zip(feature_names, feature_sizes):
        cols = features[:, off : off + size]
        feature_lists[name] = [
            ("bytes", [cols[t].tobytes()]) for t in range(features.shape[0])
        ]
        off += size
    return proto.encode_sequence_example(context, feature_lists)


@dataclasses.dataclass
class AggregatedVideo:
    video_id: str
    labels: List[int]
    features: np.ndarray  # [total_feature_size] float32


def parse_aggregated_record(
    record: bytes,
    feature_names: Sequence[str] = ("mean_rgb", "mean_audio"),
    feature_sizes: Sequence[int] = (1024, 128),
) -> AggregatedVideo:
    features_map = proto.decode_example(record)
    _, id_vals = features_map.get("id", ("bytes", [b""]))
    # errors="replace" like the frame path: a corrupt id byte must not
    # kill the epoch
    video_id = id_vals[0].decode("utf-8", "replace") if id_vals else ""
    _, label_vals = features_map.get("labels", ("int64", []))
    parts = []
    for name, size in zip(feature_names, feature_sizes):
        _, vals = features_map.get(name, ("float", [0.0] * size))
        arr = np.asarray(vals, np.float32)
        if arr.shape[0] != size:
            # validate PER FEATURE: wrong lengths that happen to sum to
            # the total would otherwise concatenate into silently
            # misaligned columns (audio bytes in rgb positions)
            raise IOError(
                f"aggregated record {video_id!r}: feature {name!r} has "
                f"{arr.shape[0]} values, expected {size} "
                "(--feature_names/--feature_sizes mismatch?)")
        parts.append(arr)
    return AggregatedVideo(
        video_id, [int(v) for v in label_vals], np.concatenate(parts)
    )


def encode_aggregated_record(
    video_id: str,
    labels: Sequence[int],
    features: np.ndarray,
    feature_names: Sequence[str] = ("mean_rgb", "mean_audio"),
    feature_sizes: Sequence[int] = (1024, 128),
) -> bytes:
    fmap = {
        "id": ("bytes", [video_id.encode("utf-8")]),
        "labels": ("int64", list(labels)),
    }
    off = 0
    for name, size in zip(feature_names, feature_sizes):
        fmap[name] = ("float", [float(x) for x in features[off : off + size]])
        off += size
    return proto.encode_example(fmap)


def read_frame_file(
    path: str,
    feature_names: Sequence[str] = ("rgb", "audio"),
    feature_sizes: Sequence[int] = (1024, 128),
    max_frames: int = 300,
    verify_crc: bool = False,
):
    """Yield FrameVideo records from one TFRecord shard (pure-Python path;
    the C++ loader in data/native is the production path)."""
    for record in TFRecordReader(path, verify_crc=verify_crc):
        yield parse_frame_record(record, feature_names, feature_sizes, max_frames)


def write_synthetic_aggregated_shard(
    path: str,
    num_videos: int,
    seed: int = 0,
    feature_names: Sequence[str] = ("mean_rgb", "mean_audio"),
    feature_sizes: Sequence[int] = (1024, 128),
    vocab_size: int = 4716,
    mean_labels: float = 3.4,
) -> List[AggregatedVideo]:
    """Generate a video-level (pre-aggregated) synthetic shard."""
    rng = np.random.default_rng(seed)
    total = sum(feature_sizes)
    truth = []
    with TFRecordWriter(path) as w:
        for i in range(num_videos):
            feats = rng.normal(size=(total,)).astype(np.float32)
            n_labels = max(1, int(rng.poisson(mean_labels)))
            labels = sorted(
                int(x) for x in rng.choice(vocab_size, size=min(n_labels, 20),
                                           replace=False)
            )
            vid = f"agg{seed:02d}_{i:05d}"
            w.write(encode_aggregated_record(vid, labels, feats, feature_names,
                                             feature_sizes))
            truth.append(AggregatedVideo(vid, labels, feats))
    return truth


def write_learnable_frame_shard(
    path: str,
    num_videos: int,
    seed: int = 0,
    pattern_seed: int = 1234,
    feature_names: Sequence[str] = ("rgb", "audio"),
    feature_sizes: Sequence[int] = (1024, 128),
    max_frames: int = 300,
    vocab_size: int = 4716,
    min_frames: int = 8,
    signal: int = 60,
) -> List[FrameVideo]:
    """Synthetic shard with a LEARNABLE label->feature mapping.

    Each class c has a fixed (pattern_seed-derived) byte-offset direction;
    a video's frames are noise plus the sum of its labels' directions, so
    a model can generalize to held-out videos generated with the same
    pattern_seed. Used by convergence tests and scripts/.
    """
    rng = np.random.default_rng(seed)
    total = sum(feature_sizes)
    pat_rng = np.random.default_rng(pattern_seed)
    patterns = pat_rng.integers(-1, 2, size=(vocab_size, total)).astype(np.int16)
    truth = []
    with TFRecordWriter(path) as w:
        for i in range(num_videos):
            nf = int(rng.integers(min_frames, max_frames + 1))
            labels = sorted(
                int(x) for x in rng.choice(vocab_size, size=int(rng.integers(1, 4)),
                                           replace=False)
            )
            base = rng.integers(60, 196, size=(nf, total), dtype=np.int16)
            for c in labels:
                base = base + signal * patterns[c][None, :]
            feats = np.clip(base, 0, 255).astype(np.uint8)
            vid = f"lv{seed:02d}_{i:05d}"
            w.write(encode_frame_record(vid, labels, feats, feature_names,
                                        feature_sizes))
            truth.append(FrameVideo(vid, labels, feats[:max_frames],
                                    min(nf, max_frames)))
    return truth


def write_synthetic_frame_shard(
    path: str,
    num_videos: int,
    seed: int = 0,
    feature_names: Sequence[str] = ("rgb", "audio"),
    feature_sizes: Sequence[int] = (1024, 128),
    max_frames: int = 300,
    vocab_size: int = 4716,
    min_frames: int = 8,
    mean_labels: float = 3.4,
) -> List[FrameVideo]:
    """Generate a YT8M-shaped synthetic shard; returns the ground truth."""
    rng = np.random.default_rng(seed)
    total = sum(feature_sizes)
    truth = []
    with TFRecordWriter(path) as w:
        for i in range(num_videos):
            nf = int(rng.integers(min_frames, max_frames + 1))
            feats = rng.integers(0, 256, size=(nf, total), dtype=np.uint8)
            n_labels = max(1, int(rng.poisson(mean_labels)))
            labels = sorted(
                int(x) for x in rng.choice(vocab_size, size=min(n_labels, 20),
                                           replace=False)
            )
            vid = f"vid{seed:02d}_{i:05d}"
            w.write(encode_frame_record(vid, labels, feats, feature_names,
                                        feature_sizes))
            truth.append(FrameVideo(vid, labels, feats[:max_frames],
                                    min(nf, max_frames)))
    return truth
