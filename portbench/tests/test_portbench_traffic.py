"""The frozen traffic: the shards parse with the port's loader, a record
is byte for byte the port's encoding, the CRCs are right, the lengths
keep to their range and every seed gets the same set of them, and the
open loop's schedule holds its rate."""

import numpy as np
import pytest

from portbench import traffic

CFG = {"max_num_frames": 300, "feature_sizes": "1024, 128", "feature_names": "rgb, audio",
       "num_classes": 4716}
POOL = {"videos": 24, "shards": 2, "seconds": [120, 500], "mean_labels": 3.4}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("pools") / "cell-7"
    return traffic.write_pool(d, POOL, CFG, 7), traffic.pool(POOL, CFG, 7)


@pytest.mark.parametrize("native", [True, False])
def test_shards_parse_with_the_ports_loader(written, native):
    from efficientvideoclassification_youtube8m_torch.data import FrameDataLoader

    pattern, videos = written
    loader = FrameDataLoader(pattern, batch_size=24, num_readers=1, shuffle=False,
                             num_epochs=1, use_native=native, deterministic=True)
    (batch,) = list(loader)
    ids = [int(v.split("_")[1]) for v in batch.video_ids]
    assert sorted(ids) == list(range(24))
    for row, i in enumerate(ids):
        n = videos["num_frames"][i]
        assert batch.num_frames[row] == n
        np.testing.assert_array_equal(batch.features[row], videos["features"][i])
        assert sorted(np.flatnonzero(batch.labels[row])) == sorted(videos["labels"][i])


def test_record_is_the_ports_encoding():
    from efficientvideoclassification_youtube8m_torch.data import yt8m

    v = traffic.pool(dict(POOL, videos=3), CFG, 11)
    for i in range(3):
        frames = v["features"][i, :v["num_frames"][i]]
        got = traffic.frame_record(f"id{i}", v["labels"][i], frames, ["rgb", "audio"],
                                   [1024, 128])
        want = yt8m.encode_frame_record(f"id{i}", [int(c) for c in v["labels"][i]], frames)
        assert got == want


def test_crc32c_and_framing(written):
    from efficientvideoclassification_youtube8m_torch.data import tfrecord

    rng = np.random.default_rng(0)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (4, 5, 8, 1023, 1024, 1025, 5000)]
    assert list(traffic.crc32c_many(msgs, 256)) == [tfrecord.crc32c(m) for m in msgs]
    pattern, _ = written
    import glob
    for path in glob.glob(pattern):
        assert sum(1 for _ in tfrecord.TFRecordReader(path, verify_crc=True)) == 12


def test_lengths_keep_their_range_and_set():
    a = traffic.lengths(1024, [120, 500], 300, 1)
    b = traffic.lengths(1024, [120, 500], 300, 2 ** 31 + 5)
    assert a.min() >= 120 and a.max() == 300
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert 255 < a.mean() < 260  # 120-500 s capped at 300 frames: about 257.4


def test_labels():
    ls = traffic.labels(2000, 4716, 3.4, 3)
    assert all(len(x) >= 1 and len(set(x)) == len(x) for x in ls)
    assert 3.3 < np.mean([len(x) for x in ls]) < 3.6


@pytest.mark.parametrize("rate,seconds", [(300.0, 20.0), (40.0, 2.0)])
def test_schedule_holds_its_rate(rate, seconds):
    due = traffic.schedule({"rate": rate}, seconds, 9)
    assert len(due) == round(rate * seconds) and due[0] == 0.0
    assert np.all(np.diff(due) > 0)
    # rate x seconds requests within the window: the gaps' quantile set
    # sums to about the window, less the one left out (at most ln(2n) / rate)
    assert seconds * 0.98 - np.log(2 * len(due)) / rate <= due[-1] <= seconds
    other = traffic.schedule({"rate": rate}, seconds, 10)
    # the same gaps in another order: the spans differ by one gap at most
    # (each schedule leaves out its last)
    assert abs(due[-1] - other[-1]) <= np.diff(due).max() * (1 + 1e-9)
    assert list(np.diff(due)) != list(np.diff(other))
