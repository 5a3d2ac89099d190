"""`device_prefetch`'s staging copy (`cli/loop._stage`) on the CPU, with the
pinned allocation made plain; the loader's pinned route
(`FrameDataLoader._array`) and `device_prefetch`'s choice to send a whole
pinned block as it is, with PyTorch's caching host allocator stood in for;
and `device_prefetch` on the card, its side stream held busy so that copies
are still running when later batches are staged or assembled (marked
`card`; this file imports no JAX, so on the card it runs with
`--noconftest`)."""

import itertools
from collections import deque, namedtuple

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_torch.cli import loop
from efficientvideoclassification_youtube8m_torch.cli.loop import device_prefetch
from efficientvideoclassification_youtube8m_torch.data import FrameDataLoader
from efficientvideoclassification_youtube8m_torch.data import loader as loader_lib
from efficientvideoclassification_youtube8m_torch.data import native, yt8m
from efficientvideoclassification_youtube8m_torch.utils import profiling

Batch = namedtuple("Batch", "features labels num_frames")


def _batch(rng, b=4, t=3, d=5, v=7):
    return Batch(rng.integers(0, 256, (b, t, d), dtype=np.uint8),
                 rng.random((b, v)) < 0.3,
                 rng.integers(1, t + 1, b).astype(np.int32))


@pytest.fixture
def unpinned(monkeypatch):
    """`torch.empty` without the pinning the CPU build cannot do; records
    that each staging buffer asked for pinned memory."""
    asked = []
    empty = torch.empty

    def plain(*args, pin_memory=False, **kwargs):
        asked.append(pin_memory)
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", plain)
    return asked


ARRAYS = {
    "features_uint8": np.arange(4 * 3 * 5, dtype=np.uint8).reshape(4, 3, 5),
    "labels_bool": np.arange(4 * 7).reshape(4, 7) % 3 == 0,
    "num_frames_int32": np.array([3, 1, 2, 3], dtype=np.int32),
    "float32": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
    "strided": np.arange(60, dtype=np.uint8).reshape(6, 10)[::2, 1::3],
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_stage_copies_the_array_into_a_pinned_buffer(unpinned, name):
    """The staged tensor holds the array's values, shape and dtype in a
    buffer of its own that was asked for in pinned memory."""
    a = ARRAYS[name]
    t = loop._stage(a)
    assert unpinned == [True]
    assert t.shape == a.shape and t.dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
    np.testing.assert_array_equal(t.numpy(), a)
    assert not np.shares_memory(t.numpy(), a)


def test_stage_runs_no_intra_op_copy(unpinned, monkeypatch):
    """The staging copy is numpy's, not a `Tensor.copy_` or `pin_memory()`,
    which would run on the intra-op thread team."""
    def refused(*args, **kwargs):
        raise AssertionError("a copy on the intra-op thread team")

    monkeypatch.setattr(torch.Tensor, "copy_", refused)
    monkeypatch.setattr(torch.Tensor, "pin_memory", refused)
    batch = _batch(np.random.default_rng(0))
    for t, a in zip(map(loop._stage, batch), batch):
        np.testing.assert_array_equal(t.numpy(), a)


def test_host_kept_labels_are_the_loaders():
    """What `device_prefetch` keeps on the host is the loader's own array,
    and every batch comes out in order."""
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(6)]
    out = list(device_prefetch(iter(batches), torch.device("cpu"), depth=2))
    assert len(out) == len(batches)
    for b, ((f, l, n), kept) in zip(batches, out):
        assert kept is b.labels
        np.testing.assert_array_equal(f.numpy(), b.features)


# ------------------------------------------------ the loader's pinned blocks

SIZES = (6, 2)
FRAMES = 24
VOCAB = 50


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """24 videos in 3 shards: batches of 5 end on a tail of 4."""
    root = tmp_path_factory.mktemp("pool")
    for s in range(3):
        yt8m.write_synthetic_frame_shard(
            str(root / f"pool-{s}.tfrecord"), 7 + s, seed=s, feature_sizes=SIZES,
            max_frames=FRAMES, vocab_size=VOCAB)
    return str(root / "pool-*.tfrecord")


def _host_allocator(monkeypatch):
    """PyTorch's caching host allocator stood in for on the CPU: the
    process reports a CUDA device, `torch.empty(..., pin_memory=True)`
    hands out a block of stale 0xFF bytes (so a byte the loader leaves
    unwritten shows), and `Tensor.is_pinned()` is true of such a block.
    Returns the blocks handed out."""
    blocks = []
    empty = torch.empty

    def stand_in(*args, pin_memory=False, **kwargs):
        t = empty(*args, **kwargs)
        if pin_memory:
            t.untyped_storage().fill_(0xFF)
            blocks.append(t)
        return t

    def is_pinned(self):
        ptr = self.untyped_storage().data_ptr()
        return any(b.untyped_storage().data_ptr() == ptr for b in blocks)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "empty", stand_in)
    monkeypatch.setattr(torch.Tensor, "is_pinned", is_pinned)
    return blocks


@pytest.fixture
def host_allocator(monkeypatch):
    return _host_allocator(monkeypatch)


def _loader(pattern, use_native, **kw):
    loader = FrameDataLoader(pattern, batch_size=5, feature_sizes=SIZES,
                             max_frames=FRAMES, vocab_size=VOCAB,
                             use_native=use_native, **kw)
    assert (loader._native is not None) == (use_native and native.available())
    return loader


@pytest.mark.parametrize("pad_final_batch", [False, True], ids=["short_tail", "padded_tail"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
@pytest.mark.parametrize("frame_stride", [1, 10])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_pinned_batches_equal_plain_batches(shards, monkeypatch, use_native,
                                            frame_stride, shuffle, pad_final_batch):
    """With a CUDA device the loader assembles each batch in blocks of the
    host allocator, every array a whole block that `device_prefetch` sends
    as it is; byte for byte they are the batches of the plain route, the
    tail's padding rows included, whatever stale bytes the blocks held.
    In order with the native parser the batcher fills them: it takes
    `_IN_FLIGHT` blocks ahead and one more a full batch, and copies a
    short tail without padding into blocks of its own."""
    kw = dict(frame_stride=frame_stride, shuffle=shuffle, seed=4,
              pad_final_batch=pad_final_batch)
    plain = list(_loader(shards, use_native, **kw))
    assert [len(b.video_ids) - b.pad for b in plain][-1] == 4
    assert all(isinstance(a, np.ndarray) and a.base is None
               for b in plain for a in (b.features, b.labels, b.num_frames))

    blocks = _host_allocator(monkeypatch)
    pinned = list(_loader(shards, use_native, **kw))
    if use_native and not shuffle:
        full = len(plain) - 1
        assert len(blocks) == 3 * (loader_lib._IN_FLIGHT + full + (not pad_final_batch))
    else:
        assert len(blocks) == 3 * len(plain)
    assert len(pinned) == len(plain)
    for p, q in zip(plain, pinned):
        assert (q.video_ids, q.pad) == (p.video_ids, p.pad)
        for a, b in zip((p.features, p.labels, p.num_frames),
                        (q.features, q.labels, q.num_frames)):
            assert loop._host_tensor(b) is b.base
            assert (b.shape, b.dtype) == (a.shape, a.dtype)
            assert b.tobytes() == a.tobytes()


def _staged_count(arrays):
    """`loop._host_tensor` of each array, under a profiler, with the
    `prefetch.staged` counter it left."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = [loop._host_tensor(a) for a in arrays]
    return out, profiling.totals()["counters"].get("prefetch.staged", 0)


def test_a_whole_loader_block_is_sent_without_a_copy(shards, host_allocator):
    """Each array of a pinned-route batch goes to the device from its own
    block: no staging copy, nothing counted."""
    batch = next(iter(_loader(shards, True)))
    arrays = (batch.features, batch.labels, batch.num_frames)
    allocated = len(host_allocator)
    out, staged = _staged_count(arrays)
    assert staged == 0 and len(host_allocator) == allocated
    for t, a in zip(out, arrays):
        assert t.data_ptr() == a.ctypes.data and t.is_pinned()
        assert t.shape == a.shape and t.dtype == torch.from_numpy(a).dtype


NOT_A_BLOCK = {
    "plain": lambda a: a.copy(),
    "slice": lambda a: a[1:],
    "strided": lambda a: a[:, ::2],
    "transposed": lambda a: a.transpose(1, 0, 2),
    "dtype_view": lambda a: a.view(np.int8),
    "reshaped": lambda a: a.reshape(a.shape[0], -1),
    "tensor_slice": lambda a: a.base[1:].numpy(),
    "tensor_transposed": lambda a: a.base.transpose(0, 1).numpy(),
    "unpinned_tensor": lambda a: torch.from_numpy(a.copy()).numpy(),
}


@pytest.mark.parametrize("name", sorted(NOT_A_BLOCK))
def test_other_arrays_are_staged_and_counted(shards, host_allocator, name):
    """An array that is not the whole of a pinned block (a plain array, a
    view or slice of a loader's block or of its tensor, the array of a
    tensor that is not pinned) is staged in a pinned buffer of its own
    and counted once."""
    batch = next(iter(_loader(shards, True)))
    a = NOT_A_BLOCK[name](batch.features)
    allocated = len(host_allocator)
    (t,), staged = _staged_count([a])
    assert staged == 1 and len(host_allocator) == allocated + 1
    assert t.data_ptr() == host_allocator[-1].data_ptr()
    assert t.dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
    np.testing.assert_array_equal(t.numpy(), a)


# ------------------------------------------------ on the card

SLEEP_CYCLES = 50_000_000  # about 30 ms of the side stream a batch
LONG_SLEEP_CYCLES = 1_700_000_000  # about 0.86 s: several times what the loader takes a batch


@pytest.fixture
def streams(monkeypatch):
    """Every `torch.cuda.Stream` made from here on, in order."""
    made = []

    class Recording(torch.cuda.Stream):
        def __new__(cls, *args, **kwargs):
            made.append(super().__new__(cls, *args, **kwargs))
            return made[-1]

    monkeypatch.setattr(torch.cuda, "Stream", Recording)
    return made


@pytest.mark.card
@pytest.mark.parametrize("depth", [1, 4])
def test_device_prefetch_on_the_card(streams, depth):
    """20 batches of the eval cell's shapes through `device_prefetch`.
    Consumed a batch at a time, as the loops do, the staging buffers come
    back from the host allocator's cache: the pool grows by at most
    (depth + 2) x 3 blocks. With the side stream made to sleep before each
    batch's copies, so they are still running when later batches are
    staged, every device batch equals its host arrays and the kept labels
    are the loader's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(depth)
    batches = [Batch(rng.integers(0, 256, (256, 30, 1152), dtype=np.uint8),
                     rng.random((256, 4716)) < 0.001,
                     rng.integers(1, 31, 256).astype(np.int32)) for _ in range(20)]

    before = torch.cuda.host_memory_stats().get("num_host_alloc", 0)  # none before the first
    for dev, _ in device_prefetch(iter(batches), device, depth=depth):
        torch.cuda.current_stream(device).synchronize()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] - before <= (depth + 2) * 3

    side = len(streams)  # the next one made is the next prefetch's side stream

    def loader():
        for b in batches:
            with torch.cuda.stream(streams[side]):
                torch.cuda._sleep(SLEEP_CYCLES)
            yield b

    out = list(device_prefetch(loader(), device, depth=depth))
    torch.cuda.synchronize(device)
    assert len(out) == len(batches)
    for b, (dev, kept) in zip(batches, out):
        assert kept is b.labels
        for d, a in zip(dev, b):
            assert d.device == device
            assert torch.equal(d.cpu(), torch.from_numpy(a))


ROUTES = {"batcher": dict(deterministic=False), "per_video": dict(deterministic=True)}


@pytest.mark.card
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("depth", [1, 4])
def test_loader_blocks_through_device_prefetch_on_the_card(tmp_path, streams, monkeypatch,
                                                           depth, route):
    """20 full-frame batches (256 x 300 x 1152) that a `FrameDataLoader`
    assembles in blocks of the host allocator, or that the native batcher
    fills there, go to the card through `device_prefetch` with no staging
    copy. The side stream sleeps longer before each batch's copy than the
    loader takes for a batch, so it falls behind: copies are still to run
    when the loader fills later batches and their blocks have been
    dropped. The loop consumes each batch on the device and drops it at
    once, and, like the eval loop's fetch, waits for the device only one
    batch behind. Every device batch equals a snapshot of its host bytes
    taken before its copy, so no block was handed out again while a copy
    still had to read it; and the allocator makes at most (depth + 3) x 3
    blocks, and `_IN_FLIGHT` x 3 more for the batcher's blocks handed in
    ahead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    device = torch.device("cuda", 0)
    # 77 videos: each batch of 256 starts at another video of the pool;
    # 7 shards keep the 4 readers busy
    for s in range(7):
        yt8m.write_synthetic_frame_shard(str(tmp_path / f"pool-{s}.tfrecord"), 11,
                                         seed=s, vocab_size=3862)
    loader = FrameDataLoader(str(tmp_path / "pool-*.tfrecord"), batch_size=256,
                             vocab_size=3862, num_readers=4, num_epochs=None,
                             shuffle=False, **ROUTES[route])
    in_place = route == "batcher"
    assert loader._fills_in_place() == in_place
    staged = []
    stage = loop._stage
    monkeypatch.setattr(loop, "_stage", lambda a: staged.append(a.shape) or stage(a))
    snapshots = []
    current = torch.cuda.current_stream(device)  # a stream object too: made first
    side = len(streams)  # the next one made is the next prefetch's side stream

    def batches():
        for b in itertools.islice(loader, 20):
            snapshots.append([a.copy() for a in (b.features, b.labels, b.num_frames)])
            with torch.cuda.stream(streams[side]):
                torch.cuda._sleep(LONG_SLEEP_CYCLES)
            yield b

    before = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
    consumed, kept_intact, lag = [], [], deque()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for dev, kept in device_prefetch(batches(), device, depth=depth):
            kept_intact.append(np.array_equal(kept, snapshots[len(consumed)][1]))
            consumed.append([d.clone() for d in dev])
            lag.append(current.record_event())
            if len(lag) > 1:
                lag.popleft().synchronize()
            del dev, kept
    torch.cuda.synchronize(device)
    counters = profiling.totals()["counters"]
    assert counters.get("prefetch.staged", 0) == 0
    assert counters.get("loader.in_place", 0) == (20 if in_place else 0)
    assert len(consumed) == len(snapshots) == 20 and staged == []
    assert consumed[0][0].shape == (256, 300, 1152)
    for got, want in zip(consumed, snapshots):
        for d, a in zip(got, want):
            assert torch.equal(d.cpu(), torch.from_numpy(a))
    assert all(kept_intact)
    ahead = loader_lib._IN_FLIGHT if in_place else 0
    assert torch.cuda.host_memory_stats()["num_host_alloc"] - before <= (depth + 3 + ahead) * 3
