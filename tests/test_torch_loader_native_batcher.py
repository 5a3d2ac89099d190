"""The loader's native batcher (`data/native.FrameBatcher`, taken by
`FrameDataLoader` in file order with the native parser) against the
pure-Python parser on the per-video route, which shares none of its
decoding: the same batches to the byte at one reader (one record stream),
every video once an epoch at four, a corrupt record raised on the
consumer with the parser's message, no reader thread left once the stream
is dropped, and the per-video route kept where the readers' order or a
shuffle needs it. The batcher's team of decoding threads is sized from the
CPUs the process may use (`os.sched_getaffinity`, set here to fake hosts):
teams larger than the streams keep every one of these. Every batch block
holds stale bytes when it is handed in, so a byte the batcher leaves
unwritten shows."""

import itertools
import os
import time
from collections import Counter

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_torch.data import FrameDataLoader
from efficientvideoclassification_youtube8m_torch.data import native, yt8m
from efficientvideoclassification_youtube8m_torch.utils import profiling

pytestmark = pytest.mark.skipif(not native.available(), reason="the native parser did not build")

SIZES = (6, 2)
WRITTEN_FRAMES = 30
FRAMES = 24  # below the longest video written: some frame counts are capped
VOCAB = 50
SHARDS = (7, 9, 6, 8, 5)  # videos a shard: 35, so batches of 4 end on a tail of 3


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("batcher")
    for s, n in enumerate(SHARDS):
        yt8m.write_synthetic_frame_shard(
            str(root / f"pool-{s}.tfrecord"), n, seed=s, feature_sizes=SIZES,
            max_frames=WRITTEN_FRAMES, vocab_size=VOCAB)
    return root


@pytest.fixture
def stale_blocks(monkeypatch):
    """`FrameDataLoader._array` handing out arrays full of 0xFF bytes
    wherever it is not asked to zero them, as a reused pinned block
    would."""
    def stale(self, shape, dtype, zero):
        a = np.zeros(shape, dtype) if zero else np.empty(shape, dtype)
        if not zero:
            a.view(np.uint8).fill(0xFF)
        return a

    monkeypatch.setattr(FrameDataLoader, "_array", stale)


def _loader(pool, per_video=False, **kw):
    kw = dict(dict(batch_size=4, feature_sizes=SIZES, max_frames=FRAMES, vocab_size=VOCAB,
                   shuffle=False), **kw)
    loader = FrameDataLoader(str(pool / "pool-*.tfrecord"), **kw)
    if per_video:
        loader._fills_in_place = lambda: False
    return loader


def _run(loader):
    """The loader's batches and the `loader.in_place` count, under a
    profiler."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        batches = list(loader)
    return batches, profiling.totals()["counters"].get("loader.in_place", 0)


def _same(want, got):
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert (b.video_ids, b.pad) == (a.video_ids, a.pad)
        for x, y in ((a.features, b.features), (a.labels, b.labels),
                     (a.num_frames, b.num_frames)):
            assert (y.shape, y.dtype) == (x.shape, x.dtype)
            assert y.tobytes() == x.tobytes()


TAILS = {"short": {}, "padded": {"pad_final_batch": True},
         "dropped": {"drop_remainder": True}}


@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("frame_stride", [1, 10])
def test_one_reader_gives_the_per_video_batches(pool, stale_blocks, frame_stride, tail):
    """At one reader over 3 epochs the batcher's batches are the pure-Python
    parser's to the byte: features (strided, padding rows zeroed, capped
    counts), labels, frame counts, ids and padding, the tail included."""
    kw = dict(num_readers=1, num_epochs=3, frame_stride=frame_stride, **TAILS[tail])
    want, none = _run(_loader(pool, use_native=False, **kw))
    got, filled = _run(_loader(pool, **kw))
    _same(want, got)
    assert none == 0 and filled == len(got)
    videos = 3 * sum(SHARDS)
    dropped = videos % 4 if tail == "dropped" else 0
    assert sum(len(b.video_ids) - b.pad for b in got) == videos - dropped
    assert got[0].features.shape[1] == -(-FRAMES // frame_stride)


def test_labels_outside_the_vocabulary_are_left_out(pool, stale_blocks):
    """A class at or above the loader's vocabulary sets no label, as with
    the pure-Python parser."""
    kw = dict(num_readers=1, vocab_size=20)
    want, _ = _run(_loader(pool, use_native=False, **kw))
    got, _ = _run(_loader(pool, **kw))
    _same(want, got)
    assert got[0].labels.shape == (4, 20)


@pytest.mark.parametrize("frame_stride", [1, 10])
def test_four_readers_hold_each_video_once_an_epoch(pool, stale_blocks, frame_stride):
    """At four readers the rows come in the readers' order, and over 3
    epochs each video comes 3 times, each time with its own row from the
    pure-Python parser."""
    rows = {}
    for b in _run(_loader(pool, use_native=False, num_readers=1,
                          frame_stride=frame_stride))[0]:
        for i, vid in enumerate(b.video_ids):
            rows[vid] = (b.features[i].tobytes(), b.labels[i].tobytes(), b.num_frames[i])
    got, filled = _run(_loader(pool, num_readers=4, num_epochs=3, frame_stride=frame_stride))
    assert filled == len(got) == -(-3 * sum(SHARDS) // 4)
    seen = Counter(vid for b in got for vid in b.video_ids)
    assert seen == {vid: 3 for vid in rows}
    for b in got:
        for i, vid in enumerate(b.video_ids):
            assert (b.features[i].tobytes(), b.labels[i].tobytes(),
                    b.num_frames[i]) == rows[vid]


def _truncated_pool(pool, tmp_path):
    """The pool with its third shard cut in its last record."""
    for s in range(len(SHARDS)):
        data = (pool / f"pool-{s}.tfrecord").read_bytes()
        (tmp_path / f"pool-{s}.tfrecord").write_bytes(data[:-40] if s == 2 else data)
    return tmp_path


def _until_error(loader):
    got = []
    with pytest.raises(Exception) as err:
        for b in loader:
            got.append(b)
    return got, err.value


def test_a_corrupt_record_raises_ioerror_on_the_consumer(pool, tmp_path, stale_blocks):
    """A record cut short raises IOError in the consumer's `next()` with the
    native per-video route's message, after the batches the pure-Python
    parser gives before its own error (the native per-video route loses
    the parse chunk around the record)."""
    cut = _truncated_pool(pool, tmp_path)
    _, native_err = _until_error(_loader(cut, per_video=True, num_readers=1))
    want, python_err = _until_error(_loader(cut, use_native=False, num_readers=1))
    got, got_err = _until_error(_loader(cut, num_readers=1))
    assert type(got_err) is type(native_err) is type(python_err) is OSError
    assert str(got_err) == str(native_err)
    assert str(got_err).startswith(f"parse error in {cut / 'pool-2.tfrecord'}: truncated")
    _same(want, got)
    assert len(got) == (7 + 9 + 5) // 4


def test_a_missing_feature_raises_where_the_python_parser_does(pool, stale_blocks):
    """A requested feature the records lack raises, as the pure-Python
    parser does, where its columns would otherwise keep a block's stale
    bytes."""
    kw = dict(feature_names=("rgb", "depth"), num_readers=1)
    with pytest.raises(ValueError, match="has 0 frames"):
        list(_loader(pool, use_native=False, **kw))
    with pytest.raises(OSError, match="per-feature frame counts differ"):
        list(_loader(pool, **kw))


def _tasks():
    return set(os.listdir("/proc/self/task"))


def _gone(tids, seconds=2.0):
    """Whether none of `tids` is a thread of this process any more, within
    `seconds` (a joined thread's entry can outlive the join briefly)."""
    end = time.monotonic() + seconds
    while tids & _tasks():
        if time.monotonic() > end:
            return False
        time.sleep(0.01)
    return True


def _drop(kind, loader):
    if kind == "break":
        for _ in loader:
            break
    elif kind == "islice":
        assert len(list(itertools.islice(loader, 3))) == 3
    else:
        it = iter(loader)
        next(it)
        it.close()


@pytest.mark.skipif(not os.path.isdir("/proc/self/task"), reason="needs /proc")
@pytest.mark.parametrize("kind", ["break", "islice", "close"])
def test_no_reader_thread_outlives_a_dropped_stream(pool, stale_blocks, kind):
    """An endless stream left after a `break`, an `islice` or a `close()`
    joins its reader threads. (Plain blocks: a pinned one would start the
    CUDA runtime's own threads.)"""
    loader = _loader(pool, num_readers=4, num_epochs=None)
    before = _tasks()
    it = iter(loader)
    next(it)
    readers = _tasks() - before
    assert len(readers) >= 4
    it.close()
    assert _gone(readers)
    before = _tasks()
    _drop(kind, loader)
    assert _gone(_tasks() - before)


ROUTES = {"shuffled": dict(shuffle=True, num_readers=1, shuffle_buffer=8),
          "ordered_readers": dict(deterministic=True, num_readers=2)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_shuffle_or_ordered_readers_keep_the_per_video_route(pool, route):
    """With a shuffle, or deterministic input over several readers, the
    batcher stays out (`loader.in_place` 0) and the batches are the
    pure-Python parser's on the same route."""
    kw = dict(num_epochs=2, seed=5, pad_final_batch=True, **ROUTES[route])
    want, _ = _run(_loader(pool, use_native=False, **kw))
    got, filled = _run(_loader(pool, **kw))
    assert filled == 0
    _same(want, got)


# ------------------------------------------------ the team beside the streams


@pytest.fixture
def cpus(monkeypatch):
    """`cpus(n)` makes the process look as if it may run on `n` CPUs, so
    that a batcher's team is `max(num_readers, n - 1)` threads; it returns
    the list that each `FrameBatcher` started records its team into."""
    teams = []

    class Recording(native.FrameBatcher):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            teams.append(self.team)

    monkeypatch.setattr(native, "FrameBatcher", Recording)

    def set_cpus(n):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(n)))
        return teams

    return set_cpus


@pytest.fixture(scope="module")
def python_rows(pool):
    """Each video's row from the pure-Python parser, by stride and id."""
    rows = {}
    for stride in (1, 10):
        loader = _loader(pool, use_native=False, num_readers=1, frame_stride=stride)
        for b in loader:
            for i, vid in enumerate(b.video_ids):
                rows[stride, vid] = (b.features[i].tobytes(), b.labels[i].tobytes(),
                                     b.num_frames[i])
    return rows


@pytest.mark.parametrize("streams", [1, 2, 4])
@pytest.mark.parametrize("team", range(1, 9))
def test_a_team_larger_than_the_streams_holds_each_video_once_an_epoch(
        pool, stale_blocks, cpus, python_rows, team, streams):
    """A team of 1-8 threads (never fewer than the streams) over 1, 2 or 4
    streams: over 3 epochs each video comes 3 times, each time with its
    own row from the pure-Python parser, to the byte."""
    teams = cpus(team + 1)
    got, filled = _run(_loader(pool, num_readers=streams, num_epochs=3))
    assert teams == [max(team, streams)]
    assert filled == len(got) == -(-3 * sum(SHARDS) // 4)
    seen = Counter(vid for b in got for vid in b.video_ids)
    assert seen == {vid: 3 for stride, vid in python_rows if stride == 1}
    for b in got:
        for i, vid in enumerate(b.video_ids):
            assert (b.features[i].tobytes(), b.labels[i].tobytes(),
                    b.num_frames[i]) == python_rows[1, vid]


@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("frame_stride", [1, 10])
def test_one_stream_with_a_team_gives_the_per_video_batches(pool, stale_blocks, cpus,
                                                           frame_stride, tail):
    """One stream decoded by a team of 4 gives the pure-Python parser's
    batches over 3 epochs to the byte: each row claimed while its record's
    stream is held keeps the stream's order, the tail included."""
    teams = cpus(5)
    kw = dict(num_readers=1, num_epochs=3, frame_stride=frame_stride, **TAILS[tail])
    want, _ = _run(_loader(pool, use_native=False, **kw))
    got, filled = _run(_loader(pool, **kw))
    assert teams == [4]
    _same(want, got)
    assert filled == len(got)


def test_a_corrupt_record_raises_ioerror_with_a_team(pool, tmp_path, stale_blocks, cpus):
    """A cut record read by one stream with a team of 4 raises IOError on
    the consumer with the parser's message, after every batch the
    pure-Python parser gives before its own error: the rows read before
    the cut one are all written before the error goes out (5 tries, as
    the threads' timing varies)."""
    cut = _truncated_pool(pool, tmp_path)
    want, _ = _until_error(_loader(cut, use_native=False, num_readers=1))
    teams = cpus(5)
    for _ in range(5):
        got, err = _until_error(_loader(cut, num_readers=1))
        assert type(err) is OSError
        assert str(err).startswith(f"parse error in {cut / 'pool-2.tfrecord'}: truncated")
        _same(want, got)
    assert teams == [4] * 5


@pytest.mark.skipif(not os.path.isdir("/proc/self/task"), reason="needs /proc")
@pytest.mark.parametrize("kind", ["break", "islice", "close"])
def test_no_thread_of_a_team_outlives_a_dropped_stream(pool, stale_blocks, cpus, kind):
    """A team of 8 over 2 streams, endless: after a `break`, an `islice` or
    a `close()` none of its threads is left."""
    teams = cpus(9)
    loader = _loader(pool, num_readers=2, num_epochs=None)
    before = _tasks()
    it = iter(loader)
    next(it)
    team = _tasks() - before
    assert len(team) >= 8
    it.close()
    assert _gone(team)
    before = _tasks()
    _drop(kind, loader)
    assert _gone(_tasks() - before)
    assert teams == [8, 8]


@pytest.mark.skipif(not os.path.isdir("/proc/self/task"), reason="needs /proc")
@pytest.mark.parametrize("num_readers", [1, 2, 4])
@pytest.mark.parametrize("n_cpus", [1, 2, 8])
def test_the_team_is_sized_from_the_cpus_and_never_below_the_streams(
        pool, stale_blocks, cpus, n_cpus, num_readers):
    """On a process that may run on 1, 2 or 8 CPUs the team is one thread a
    CPU less one for the loop's thread, and never fewer than the
    `num_readers` streams; so many threads start."""
    teams = cpus(n_cpus)
    want = max(num_readers, n_cpus - 1)
    assert native.team_size(num_readers) == want
    loader = _loader(pool, num_readers=num_readers, num_epochs=None)
    before = _tasks()
    it = iter(loader)
    next(it)
    assert len(_tasks() - before) == want
    it.close()
    assert teams == [want]
