"""The port's copy of the data plane against the JAX package's: the same
seed writes byte-identical shards, both loaders give identical batches
(native and pure-Python parser, with and without frame_stride), a TF-V2
bundle written by the JAX package lists and reads identically, and the port's native library is
built under build/native/, not beside its sources."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from efficientvideoclassification_youtube8m_tpu import data as jdata
from efficientvideoclassification_youtube8m_tpu.data import tf_checkpoint as jtf
from efficientvideoclassification_youtube8m_tpu.data import tfrecord as jtfrecord
from efficientvideoclassification_youtube8m_tpu.data import yt8m as jyt8m
from efficientvideoclassification_youtube8m_torch import data as tdata
from efficientvideoclassification_youtube8m_torch.data import native as tnative
from efficientvideoclassification_youtube8m_torch.data import proto as tproto
from efficientvideoclassification_youtube8m_torch.data import tf_checkpoint as ttf
from efficientvideoclassification_youtube8m_torch.data import tfrecord as ttfrecord
from efficientvideoclassification_youtube8m_torch.data import yt8m as tyt8m

SIZES = (6, 2)
FRAMES = 24
VOCAB = 50


def _frame_kw():
    return dict(feature_names=("rgb", "audio"), feature_sizes=SIZES,
                max_frames=FRAMES, vocab_size=VOCAB)


WRITERS = {
    "synthetic": ("write_synthetic_frame_shard", _frame_kw()),
    "learnable": ("write_learnable_frame_shard", _frame_kw()),
}


@pytest.mark.parametrize("kind", sorted(WRITERS))
@pytest.mark.parametrize("seed", [0, 5])
def test_writers_byte_identical(tmp_path, kind, seed):
    name, kw = WRITERS[kind]
    jax_truth = getattr(jyt8m, name)(str(tmp_path / "jax.tfrecord"), 9, seed=seed, **kw)
    port_truth = getattr(tyt8m, name)(str(tmp_path / "port.tfrecord"), 9, seed=seed, **kw)
    assert (tmp_path / "jax.tfrecord").read_bytes() == (tmp_path / "port.tfrecord").read_bytes()
    for a, b in zip(jax_truth, port_truth):
        assert a.video_id == b.video_id and a.labels == b.labels
        np.testing.assert_array_equal(a.features, b.features)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    for s in range(3):
        jdata.write_synthetic_frame_shard(str(root / f"train-{s}.tfrecord"), 7 + s,
                                          seed=s, **_frame_kw())
    return root


def _batches(module, pattern, **kw):
    return list(module.FrameDataLoader(pattern, **kw))


def _assert_same_batches(want, got):
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert type(a).__name__ == type(b).__name__
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, field.name
                np.testing.assert_array_equal(x, y, err_msg=field.name)
            else:
                assert x == y, field.name


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("frame_stride", [1, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_frame_loaders_identical(shards, use_native, frame_stride, shuffle):
    kw = dict(batch_size=4, feature_names=("rgb", "audio"), feature_sizes=SIZES,
              max_frames=FRAMES, vocab_size=VOCAB, num_readers=2,
              deterministic=True, num_epochs=2, shuffle=shuffle, seed=3,
              pad_final_batch=not shuffle, use_native=use_native,
              frame_stride=frame_stride)
    pattern = str(shards / "train-*.tfrecord")
    want = _batches(jdata, pattern, **kw)
    got = _batches(tdata, pattern, **kw)
    _assert_same_batches(want, got)
    assert got[0].features.shape[1] == -(-FRAMES // frame_stride)


def test_native_and_python_parsers_agree(shards):
    """The port's own two parsers give the same batches."""
    kw = dict(batch_size=5, feature_names=("rgb", "audio"), feature_sizes=SIZES,
              max_frames=FRAMES, vocab_size=VOCAB, shuffle=False,
              pad_final_batch=True, frame_stride=2)
    pattern = str(shards / "train-*.tfrecord")
    _assert_same_batches(_batches(tdata, pattern, use_native=False, **kw),
                         _batches(tdata, pattern, use_native=True, **kw))


def test_native_library_under_build():
    assert tnative.available()
    path = tnative.library_path()
    assert tnative.loaded_path() == path and path.exists()
    root = Path(tdata.__file__).resolve().parents[2]
    assert path.parent == root / "build" / "native"
    assert not list(Path(tnative.__file__).parent.glob("*.so"))


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(1000),
                                  bytes(range(256)) * 33])
def test_crc32c_and_records_identical(tmp_path, data):
    assert ttfrecord.crc32c(data) == jtfrecord.crc32c(data)
    assert ttfrecord.masked_crc32c(data) == jtfrecord.masked_crc32c(data)
    for module, name in ((jtfrecord, "jax"), (ttfrecord, "port")):
        with module.TFRecordWriter(str(tmp_path / name)) as w:
            w.write(data)
            w.write(data[::-1])
    assert (tmp_path / "jax").read_bytes() == (tmp_path / "port").read_bytes()
    assert list(ttfrecord.TFRecordReader(str(tmp_path / "jax"), verify_crc=True)) == [
        data, data[::-1]]


def test_proto_fields_identical(shards):
    from efficientvideoclassification_youtube8m_tpu.data import proto as jproto

    for record in ttfrecord.TFRecordReader(str(shards / "train-0.tfrecord")):
        assert list(tproto.iter_fields(record)) == list(jproto.iter_fields(record))
        assert tproto.decode_sequence_example(record) == jproto.decode_sequence_example(record)


def test_tf_checkpoint_lists_and_reads_identically(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "model/rnn/kernel": rng.normal(size=(5, 8)).astype(np.float32),
        "model/rnn/bias": rng.normal(size=(8,)).astype(np.float32),
        "global_step": np.array(42, np.int64),
        "counts": rng.integers(0, 9, size=(3, 2)).astype(np.int32),
    }
    prefix = jtf.write_tf_checkpoint(str(tmp_path / "model.ckpt-42"), tensors)
    jreader, treader = jtf.TFCheckpointReader(prefix), ttf.TFCheckpointReader(prefix)
    assert treader.list_variables() == jreader.list_variables()
    for name, _, _ in treader.list_variables():
        got, want = treader.get_tensor(name), jreader.get_tensor(name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tensors[name])
    assert ttf.is_tf_checkpoint(prefix) and jtf.is_tf_checkpoint(prefix)
    assert ttf.latest_tf_checkpoint(str(tmp_path)) == jtf.latest_tf_checkpoint(str(tmp_path))
