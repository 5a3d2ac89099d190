"""Threaded host-side input pipeline (a copy of the JAX package's
data/loader.py: the same batches from the same shards and seed).

Replaces the reference's TF1 queue-runner machinery
(`string_input_producer` + `shuffle_batch_join`,
`train.py:154-176`) with a plain
producer/consumer design:

  reader threads (one per `num_readers`, like the reference's flag)
    -> bounded video queue (capacity ~= 50 * batch like the reference)
      -> batch assembler with an in-memory shuffle buffer

Batches carry RAW uint8 features — dequantize/l2-normalize run on the
device inside the step — so host->device traffic is 1/4 of the f32
equivalent. Files can be sharded across hosts (`shard_index` /
`num_shards`) for data-parallel multi-host input.

The record parser is pluggable: the C++ native parser
(data/native, ~40x the pure-Python throughput) is used when built,
with `yt8m.parse_frame_record` as fallback.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import os
import queue
import random
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from efficientvideoclassification_youtube8m_torch.data import yt8m
from efficientvideoclassification_youtube8m_torch.data.tfrecord import TFRecordReader

_STOP = object()
_FILE_END = object()
_STREAM_END = object()

_allocator_tuned = False


def _tune_allocator() -> None:
    """Keep the pipeline's multi-MB buffers in the malloc arena.

    The parser's chunk buffers (~11 MB at full frames) and the batch
    arrays are above glibc's default mmap threshold, so every
    allocate/free cycle is an mmap+munmap — page-table churn plus
    kernel zeroing of every page on the next touch. Raising the
    threshold (and the matching trim threshold) makes glibc recycle
    them from the arena instead: measured ~4.1k -> ~5.1k videos/s
    steady-state on the full-frame loader (+20-25%, and the worst-case
    runs — where glibc's dynamic threshold never adapts — go from ~4x
    system-time blowups to a 0.13s sys floor), with equal-or-lower peak
    RSS (one warm arena vs rotating fresh mmaps). Process-global but
    benign here; set YT8M_NO_MALLOPT=1 to skip. No-op off glibc."""
    global _allocator_tuned
    if _allocator_tuned or os.environ.get("YT8M_NO_MALLOPT"):
        return
    _allocator_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        m_mmap_threshold, m_trim_threshold = -3, -1
        libc.mallopt(m_mmap_threshold, 64 * 1024 * 1024)
        libc.mallopt(m_trim_threshold, 64 * 1024 * 1024)
    except OSError:  # musl/macOS etc. — default allocator behavior
        pass


@dataclasses.dataclass
class FrameBatch:
    video_ids: List[str]
    features: np.ndarray  # [B, feature_rows, total_size] uint8 (zero-
    # padded); feature_rows = ceil(max_frames / frame_stride)
    labels: np.ndarray  # [B, vocab] bool
    num_frames: np.ndarray  # [B] int32
    pad: int = 0  # trailing rows that are padding (eval tail batches)


class FrameDataLoader:
    """Iterates FrameBatch over a glob of TFRecord shards."""

    def __init__(
        self,
        data_pattern: str,
        batch_size: int,
        feature_names: Sequence[str] = ("rgb", "audio"),
        feature_sizes: Sequence[int] = (1024, 128),
        max_frames: int = 300,
        vocab_size: int = 4716,
        num_readers: int = 1,
        num_epochs: Optional[int] = 1,
        shuffle: bool = True,
        shuffle_buffer: Optional[int] = None,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        pad_final_batch: bool = False,
        drop_remainder: bool = False,
        use_native: bool = True,
        bagging: bool = False,
        frame_stride: int = 1,
        deterministic: bool = False,
    ):
        _tune_allocator()
        self.files = sorted(globlib.glob(data_pattern))
        if not self.files:
            raise IOError(f"Unable to find training files. data_pattern='{data_pattern}'")
        total_files = len(self.files)
        self.files = self.files[shard_index::num_shards]
        if not self.files:
            # an empty per-host shard would silently stop EVERY host at
            # step 0 (sync_host_streams' cross-host drop_remainder) —
            # fail loudly instead
            raise IOError(
                f"host shard {shard_index}/{num_shards} is empty: only "
                f"{total_files} input files match '{data_pattern}' — need "
                f"at least {num_shards} files (one per process)"
            )
        if bagging:
            # bootstrap-resample the shard list with replacement for
            # ensemble-member diversity (train.py:160-163); the reference
            # seeds from wall time — here from `seed` for reproducibility
            brng = np.random.default_rng(seed)
            self.files = list(brng.choice(self.files, len(self.files),
                                          replace=True))
        self.batch_size = batch_size
        self.feature_names = list(feature_names)
        self.feature_sizes = list(feature_sizes)
        self.total_size = sum(feature_sizes)
        self.max_frames = max_frames
        # keep every frame_stride-th frame (the student paths' every_n):
        # the native parser then decodes 1/stride the bytes, and batches
        # carry [B, feature_rows, D] with feature_rows = ceil(max/stride);
        # num_frames stays the ORIGINAL count (consumers' seq-len math)
        self.frame_stride = max(1, frame_stride)
        self.feature_rows = (max_frames + self.frame_stride - 1) // self.frame_stride
        self.vocab_size = vocab_size
        self.num_readers = max(1, num_readers)
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        # never below batch_size: a smaller buffer would make EVERY
        # mid-stream batch undersized (the take=min(batch, buffer) fill
        # loop), breaking the step's static batch shape
        self.shuffle_buffer = max(shuffle_buffer or 5 * batch_size,
                                  batch_size)
        self.seed = seed
        self.pad_final_batch = pad_final_batch
        self.drop_remainder = drop_remainder
        self.deterministic = deterministic

        self._native = None
        if use_native:
            try:
                from efficientvideoclassification_youtube8m_torch.data import native

                if native.available():
                    self._native = native
            except ImportError:
                pass

    # ------------------------------------------------------------------
    def _iter_file(self, path: str) -> Iterator[yt8m.FrameVideo]:
        if self._native is not None:
            yield from self._native.read_frame_file(
                path, self.feature_names, self.feature_sizes, self.max_frames,
                stride=self.frame_stride,
                # a valid record cannot carry more distinct labels than
                # the vocabulary, so this cap can only trip on corrupt
                # data (where the parser raises instead of truncating)
                labels_cap=max(64, self.vocab_size),
            )
        else:
            for record in TFRecordReader(path):
                video = yt8m.parse_frame_record(
                    record, self.feature_names, self.feature_sizes, self.max_frames
                )
                if self.frame_stride > 1:
                    # contiguous copy: a strided VIEW would pin the full
                    # [max_frames, D] buffer in the shuffle queue
                    video = dataclasses.replace(
                        video,
                        features=np.ascontiguousarray(
                            video.features[:: self.frame_stride]
                        ),
                    )
                yield video

    def _file_stream(self, rng: random.Random) -> Iterator[str]:
        """Epoch-concatenated (optionally per-epoch shuffled) file paths;
        infinite when num_epochs is None (string_input_producer
        semantics)."""
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            shard_list = list(self.files)
            if self.shuffle:
                rng.shuffle(shard_list)
            yield from shard_list
            epoch += 1

    @staticmethod
    def _stoppable_put(q: "queue.Queue", item, stop: threading.Event) -> bool:
        """put() that gives up when the consumer abandoned the stream —
        a plain blocking put would leave the reader thread pinned on a
        full queue (and its parsed videos in memory) for the process
        lifetime if the iterator is dropped mid-epoch (islice/break).
        The timeout path only engages when the queue is FULL; the
        common non-blocking insert is unchanged."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _reader_thread(self, next_file, video_q: "queue.Queue",
                       stop: threading.Event):
        while not stop.is_set():
            path = next_file()
            if path is None:
                self._stoppable_put(video_q, _STOP, stop)
                return
            try:
                for video in self._iter_file(path):
                    if not self._stoppable_put(video_q, video, stop):
                        return
            except Exception as e:  # surface loader errors to the consumer
                self._stoppable_put(video_q, e, stop)
                return

    def _videos_workstealing(self, file_rng) -> Iterator[yt8m.FrameVideo]:
        """Default multi-reader stream: readers pull files from a shared
        iterator (work stealing — best throughput under skewed shard
        sizes) and feed one bounded queue; arrival order depends on
        thread timing, like the reference's parallel-reader
        `shuffle_batch_join` (train.py:154-176)."""
        video_q: "queue.Queue" = queue.Queue(maxsize=max(50 * self.batch_size, 256))
        file_iter = self._file_stream(file_rng)
        file_lock = threading.Lock()
        stop = threading.Event()

        def next_file():
            with file_lock:
                return next(file_iter, None)

        threads = [
            threading.Thread(
                target=self._reader_thread, args=(next_file, video_q, stop),
                daemon=True,
            )
            for _ in range(self.num_readers)
        ]
        for t in threads:
            t.start()
        try:
            finished_readers = 0
            while finished_readers < len(threads):
                item = video_q.get()
                if item is _STOP:
                    finished_readers += 1
                elif isinstance(item, Exception):
                    raise item
                else:
                    yield item
        finally:
            stop.set()  # unwind blocked readers if the consumer bailed

    def _videos_deterministic(self, file_rng) -> Iterator[yt8m.FrameVideo]:
        """Deterministic multi-reader stream (`deterministic=True`):
        files are dispatched ROUND-ROBIN to per-reader queues and
        drained strictly in file order (a FILE_END sentinel bounds each
        file), so the yielded stream is identical to num_readers=1 —
        batch composition no longer depends on thread timing — while
        readers still parse several files ahead concurrently."""
        R = self.num_readers
        file_qs = [queue.Queue(maxsize=2) for _ in range(R)]
        video_qs = [
            queue.Queue(maxsize=max((50 * self.batch_size) // R, 64))
            for _ in range(R)
        ]
        stop = threading.Event()

        def dispatcher():
            for i, path in enumerate(self._file_stream(file_rng)):
                if not self._stoppable_put(file_qs[i % R], path, stop):
                    return
            for q in file_qs:
                self._stoppable_put(q, None, stop)

        def _stoppable_get(q):
            while not stop.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return None

        def reader(r):
            while not stop.is_set():
                path = _stoppable_get(file_qs[r])
                if path is None:
                    self._stoppable_put(video_qs[r], _STREAM_END, stop)
                    return
                try:
                    for v in self._iter_file(path):
                        if not self._stoppable_put(video_qs[r], v, stop):
                            return
                    if not self._stoppable_put(video_qs[r], _FILE_END, stop):
                        return
                except Exception as e:  # surfaced when the drain reaches it
                    self._stoppable_put(video_qs[r], e, stop)
                    return

        threads = [threading.Thread(target=dispatcher, daemon=True)] + [
            threading.Thread(target=reader, args=(r,), daemon=True)
            for r in range(R)
        ]
        for t in threads:
            t.start()
        try:
            k = 0  # global file index being drained
            while True:
                q = video_qs[k % R]
                while True:
                    item = q.get()
                    if item is _FILE_END:
                        break
                    if item is _STREAM_END:
                        return
                    if isinstance(item, Exception):
                        raise item
                    yield item
                k += 1
        finally:
            stop.set()  # unwind blocked readers if the consumer bailed

    def __iter__(self) -> Iterator[FrameBatch]:
        # distinct Random instances: the file stream's is advanced inside
        # reader threads while the consumer thread draws from the shuffle
        # buffer — sharing one would race and break the seeded determinism
        file_rng = random.Random(self.seed)
        rng = random.Random(self.seed + 1)
        if self.deterministic and self.num_readers > 1:
            videos = self._videos_deterministic(file_rng)
        else:
            videos = self._videos_workstealing(file_rng)

        buffer: List[yt8m.FrameVideo] = []
        exhausted = False
        while True:
            while not exhausted and len(buffer) < (
                self.shuffle_buffer if self.shuffle else self.batch_size
            ):
                try:
                    v = next(videos)
                    if self.shuffle and v.features.base is not None:
                        # own the bytes before they sit in the shuffle
                        # buffer: the native parser yields VIEWS into
                        # whole 32-video parse blocks, and random
                        # eviction leaves straggler videos pinning
                        # entire blocks (multi-GB host RSS at flagship
                        # batch/buffer sizes). FIFO (no-shuffle) drains
                        # blocks promptly and keeps zero-copy.
                        v = dataclasses.replace(v,
                                                features=v.features.copy())
                    buffer.append(v)
                except StopIteration:
                    exhausted = True
            if not buffer:
                return
            take = min(self.batch_size, len(buffer))
            if take < self.batch_size and self.drop_remainder and exhausted:
                # keep batch shapes static without training on fabricated
                # padding rows: skip the tail (< one batch per epoch)
                return
            if self.shuffle:
                picked = [
                    buffer.pop(rng.randrange(len(buffer))) for _ in range(take)
                ]
            else:
                picked, buffer = buffer[:take], buffer[take:]
            if take < self.batch_size and not self.pad_final_batch and exhausted:
                yield self._assemble(picked, pad=0)
                return
            yield self._assemble(
                picked,
                pad=(self.batch_size - take) if self.pad_final_batch else 0,
            )
            if exhausted and not buffer:
                return

    # ------------------------------------------------------------------
    def _assemble(self, videos: List, pad: int) -> FrameBatch:
        n = len(videos)
        B = n + pad
        all_padded = all(v.padded for v in videos)
        if all_padded:
            # native-parser videos arrive pre-padded: one block copy per
            # video, no batch-wide memset
            features = np.empty((B, self.feature_rows, self.total_size),
                                np.uint8)
            if pad:
                features[n:] = 0
        else:
            features = np.zeros((B, self.feature_rows, self.total_size),
                                np.uint8)
        labels = np.zeros((B, self.vocab_size), bool)
        num_frames = np.zeros((B,), np.int32)
        ids = []
        for i, v in enumerate(videos):
            nf = v.num_frames
            if all_padded:
                features[i] = v.features
            else:
                rows = v.features.shape[0]  # already strided/capped
                features[i, :rows] = v.features
            for c in v.labels:
                if 0 <= c < self.vocab_size:
                    labels[i, c] = True
            num_frames[i] = nf
            ids.append(v.video_id)
        ids.extend([""] * pad)
        return FrameBatch(ids, features, labels, num_frames, pad=pad)
