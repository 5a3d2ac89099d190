"""`device_prefetch`'s staging copy (`cli/loop._stage`) on the CPU, with the
pinned allocation made plain; and `device_prefetch` on the card, its side
stream held busy so that copies are still running when later batches are
staged (marked `card`; this file imports no JAX, so on the card it runs
with `--noconftest`)."""

from collections import namedtuple

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_torch.cli import loop
from efficientvideoclassification_youtube8m_torch.cli.loop import device_prefetch

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


# ------------------------------------------------ on the card

SLEEP_CYCLES = 50_000_000  # about 30 ms of the side stream a batch


@pytest.mark.card
@pytest.mark.parametrize("depth", [1, 4])
def test_device_prefetch_on_the_card(monkeypatch, depth):
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
    streams = []  # every stream object made from here on

    class Recording(torch.cuda.Stream):
        def __new__(cls, *args, **kwargs):
            streams.append(super().__new__(cls, *args, **kwargs))
            return streams[-1]

    monkeypatch.setattr(torch.cuda, "Stream", Recording)
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
