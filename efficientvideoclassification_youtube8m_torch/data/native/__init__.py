"""ctypes bindings for the native YT8M TFRecord/SequenceExample parser
and the AP heap kernels (a copy of the JAX package's data/native, with
its own build).

Builds the library from yt8m_io.cc and heap.cc on first use (g++ -O3; a
few seconds) into `build/native/` at the root of the checkout, named by a
hash of the sources, the flags and the host (`-march=native` code runs
only on the CPU it was built for), so an edited source rebuilds and
nothing is written beside the sources. Falls back cleanly —
`available()` returns False and the pure-Python parser takes over — if
no compiler is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from efficientvideoclassification_youtube8m_torch.data.yt8m import FrameVideo

_DIR = Path(__file__).resolve().parent
_SOURCES = (_DIR / "yt8m_io.cc", _DIR / "heap.cc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
_FLAGS = (
    "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
    # no FMA contraction: the AP sweep (heap.cc) must reproduce the
    # Python float op sequence bit-for-bit (mul+add contracted into
    # fma rounds once instead of twice)
    "-ffp-contract=off",
)

_lib = None
_lib_path: Optional[Path] = None
_build_failed = False  # negative cache: one compile attempt per process
_lock = threading.Lock()
_ID_CAP = 256


def library_path() -> Path:
    """Where the library is (or will be) built: keyed by the sources, the
    flags and the host name."""
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(_FLAGS).encode() + b"\0" + platform.node().encode())
    return BUILD_DIR / f"libyt8m_io-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    # compile to a process-unique temp path and os.replace() into place:
    # concurrent PROCESSES (the in-process _lock can't see them — e.g.
    # several CLIs launched together) would otherwise race g++ on the
    # same output file and CDLL() a half-written .so
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, *map(str, _SOURCES), "-o", str(tmp)]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)  # atomic on POSIX
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _load():
    global _lib, _lib_path, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None  # don't re-run a multi-second compile per loader
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.yt8m_open.restype = ctypes.c_void_p
        lib.yt8m_open.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,  # stride
        ]
        lib.yt8m_next_batch.restype = ctypes.c_int32
        lib.yt8m_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.yt8m_error.restype = ctypes.c_char_p
        lib.yt8m_error.argtypes = [ctypes.c_void_p]
        lib.yt8m_close.argtypes = [ctypes.c_void_p]
        lib.yt8m_crc32c.restype = ctypes.c_uint32
        lib.yt8m_crc32c.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
        lib.yt8m_crc32c_ext.restype = ctypes.c_uint32
        lib.yt8m_crc32c_ext.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64, ctypes.c_uint32,
        ]
        _f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        _i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.ap_heap_push.restype = ctypes.c_int64
        lib.ap_heap_push.argtypes = [
            _f64p, _f64p, ctypes.c_int64, ctypes.c_int64,
            _f64p, _f64p, ctypes.c_int64,
        ]
        lib.ap_heap_build_segments.restype = None
        lib.ap_heap_build_segments.argtypes = [
            _f64p, _f64p, _i64p, _i64p, ctypes.c_int64,
        ]
        lib.ap_sample_perm.restype = None
        lib.ap_sample_perm.argtypes = [ctypes.c_uint32, ctypes.c_int64, _i64p]
        lib.ap_sweep_segments.restype = None
        lib.ap_sweep_segments.argtypes = [
            _f64p, _f64p, _i64p, _i64p, _f64p,
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64, _f64p,
        ]
        lib.group_by_class_sort.restype = None
        lib.group_by_class_sort.argtypes = [
            _i64p, _f64p, _f64p, ctypes.c_int64, ctypes.c_int64,
            _i64p, _f64p, _f64p,
        ]
        _lib, _lib_path = lib, path
        return _lib


def available() -> bool:
    return _load() is not None


def loaded_path() -> Optional[Path]:
    """The library this process loaded, or None (not built, or no g++)."""
    return _lib_path


def heap_push(pred_heap: np.ndarray, act_heap: np.ndarray, size: int,
              top_n: int, preds: np.ndarray, acts: np.ndarray) -> int:
    """Bulk heapq-exact pushes (heap.cc) into the parallel f64 heap
    arrays; returns the new heap length. top_n < 0 = unbounded."""
    lib = _load()
    return lib.ap_heap_push(pred_heap, act_heap, size, top_n,
                            preds, acts, preds.shape[0])


def heap_build_segments(preds: np.ndarray, acts: np.ndarray,
                        starts: np.ndarray, ends: np.ndarray):
    """In-place heapq-exact heapify of contiguous segments (heap.cc)."""
    lib = _load()
    lib.ap_heap_build_segments(preds, acts, starts, ends, starts.shape[0])


def sample_perm(n: int, seed: int = 0) -> np.ndarray:
    """CPython-exact `random.seed(seed); random.sample(range(n), n)`
    permutation (heap.cc MT19937 replay) as an int64 array."""
    lib = _load()
    out = np.empty(n, np.int64)
    lib.ap_sample_perm(seed, n, out)
    return out


def ap_sweep(preds: np.ndarray, acts: np.ndarray, starts: np.ndarray,
             ends: np.ndarray, num_pos: np.ndarray, top_n: int,
             seed: int = 0) -> np.ndarray:
    """AP@n per segment (shuffle + stable sort + sweep in C, heap.cc);
    top_n < 0 = unbounded."""
    lib = _load()
    out = np.empty(starts.shape[0], np.float64)
    lib.ap_sweep_segments(preds, acts, starts, ends, num_pos, top_n, seed,
                          starts.shape[0], out)
    return out


def group_by_class(classes: np.ndarray, preds: np.ndarray,
                   acts: np.ndarray, num_class: int):
    """Stable class-sorted (preds, acts) streams + per-class counts via
    the O(n) C counting sort (heap.cc group_by_class_sort) — same order
    as the stable composite-key argsort in eval_util._class_sorted but
    ~20x faster at epoch scale. Returns (sorted_preds, sorted_acts,
    counts[num_class])."""
    lib = _load()
    n = classes.shape[0]
    classes = np.ascontiguousarray(classes, np.int64)
    if n and (classes.min() < 0 or classes.max() >= num_class):
        # the C counting sort indexes counts[classes[i]] unguarded — an
        # out-of-range id would corrupt the heap, not raise
        raise ValueError(
            f"class ids must be in [0, {num_class}); got "
            f"[{classes.min()}, {classes.max()}]")
    counts = np.empty(num_class, np.int64)
    out_p = np.empty(n, np.float64)
    out_a = np.empty(n, np.float64)
    lib.group_by_class_sort(
        classes,
        np.ascontiguousarray(preds, np.float64),
        np.ascontiguousarray(acts, np.float64),
        n, num_class, counts, out_p, out_a)
    return out_p, out_a, counts


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C; `crc` is a finalized value to continue from (incremental
    use), 0 for a fresh checksum — matching data/tfrecord.py's fallback."""
    lib = _load()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return lib.yt8m_crc32c_ext(buf, len(data), crc & 0xFFFFFFFF)


def read_frame_file(
    path: str,
    feature_names: Sequence[str] = ("rgb", "audio"),
    feature_sizes: Sequence[int] = (1024, 128),
    max_frames: int = 300,
    verify_crc: bool = False,
    batch: int = 32,
    labels_cap: int = 64,
    stride: int = 1,
) -> Iterator[FrameVideo]:
    """Yield FrameVideo records via the native parser.

    Features come back already padded to [out_rows, total] where
    out_rows = ceil(max_frames / stride); with stride > 1 only every
    stride-th frame is decoded (the student paths' every_n — 1/stride
    the parse memcpy bytes). num_frames records the true (capped)
    ORIGINAL count, matching readers.py:234.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    stride = max(1, stride)  # mirror the C++ clamp
    names = (ctypes.c_char_p * len(feature_names))(
        *[n.encode() for n in feature_names]
    )
    sizes = (ctypes.c_int32 * len(feature_sizes))(*feature_sizes)
    total = sum(feature_sizes)
    reader = lib.yt8m_open(
        path.encode(), names, sizes, len(feature_names), max_frames,
        1 if verify_crc else 0, stride,
    )
    if not reader:
        raise IOError(f"cannot open {path}")
    try:
        num_frames = np.empty((batch,), np.int32)
        labels = np.empty((batch, labels_cap), np.int32)
        num_labels = np.empty((batch,), np.int32)
        ids = ctypes.create_string_buffer(batch * _ID_CAP)
        out_rows = (max_frames + stride - 1) // stride
        while True:
            # fresh buffer per batch so the yielded views stay valid
            feats = np.empty((batch, out_rows, total), np.uint8)
            n = lib.yt8m_next_batch(
                reader, batch,
                feats.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                num_frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                labels_cap,
                num_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ids, _ID_CAP,
            )
            if n < 0:
                raise IOError(
                    f"parse error in {path}: {lib.yt8m_error(reader).decode()}"
                )
            for i in range(n):
                vid = ids.raw[i * _ID_CAP : (i + 1) * _ID_CAP].split(b"\0", 1)[0]
                if num_labels[i] > labels_cap:
                    # the C parser reports the TRUE count but stores only
                    # the first labels_cap — refusing beats silently
                    # diverging from the pure-Python parser
                    raise IOError(
                        f"record in {path} has {int(num_labels[i])} "
                        f"labels > labels_cap {labels_cap}; pass a "
                        "larger labels_cap (the loader sizes it to the "
                        "vocabulary)")
                yield FrameVideo(
                    video_id=vid.decode("utf-8", "replace"),
                    labels=labels[i, : num_labels[i]].tolist(),
                    features=feats[i],  # zero-copy view; buffer not reused
                    num_frames=int(num_frames[i]),
                    padded=True,
                )
            if n < batch:
                return
    finally:
        lib.yt8m_close(reader)
