"""`decode_busy.vlad_eval` and `decode_busy.lstm_eval` over synthetic span
records: the `loader.decode` seconds inside the loop's recorded stretch,
each span clipped to it, over the distinct threads that recorded them
there times the stretch; None with no records, with no loop thread, and
on a program without `records()`."""

import math

import pytest

from portbench import run
from portbench.tests.small import bench

METRICS = ["decode_busy.vlad_eval", "decode_busy.lstm_eval"]
S = 10 ** 9


class _Run:
    flags = {"num_readers": 4}


def _records(monkeypatch, recs):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    monkeypatch.setattr(profiling, "records", lambda: recs)


@pytest.mark.parametrize("metric", METRICS)
def test_the_metric_is_in_the_benchmark_for_its_cell(metric):
    cell = {"decode_busy.vlad_eval": "nextvlad_eval.b256",
            "decode_busy.lstm_eval": "lstm_eval.b256"}[metric]
    entry = {m["name"]: m for m in bench()["per_layer"]}[metric]
    assert entry["workloads"] == [cell]
    assert entry["moves"] == "eval_videos_per_s" and entry["unit"] == "%"


@pytest.mark.parametrize("metric", METRICS)
def test_clipped_to_the_loop_stretch_over_the_teams_threads(monkeypatch, metric):
    """A loop stretch of 2 s (from the loop thread's first span to its
    last). Three team threads decode inside it: 1 s, 0.5 s, and a decode
    that runs on past the stretch by 3 s (counted 0.5 s); a fourth thread
    decodes only before the stretch and is no member of it; reads and
    other spans are not counted."""
    recs = [("loader.queue_wait", 1, S, 2 * S, None, None),
            ("eval.accumulate", 1, 2 * S, 3 * S, None, 0),
            ("loader.decode", 10, S, 2 * S, None, None),
            ("loader.decode", 11, S + S // 2, 2 * S, None, None),
            ("loader.decode", 12, 3 * S - S // 2, 6 * S, None, None),
            ("loader.decode", 13, 0, S, None, None),
            ("loader.parse", 14, S, 3 * S, None, None)]
    _records(monkeypatch, recs)
    assert math.isclose(run.load_reader(metric)(_Run()), 100.0 * 2.0 / (3 * 2))
    # one thread's two decodes count it once
    _records(monkeypatch, recs + [("loader.decode", 10, 2 * S, 2 * S + S // 2, None, None)])
    assert math.isclose(run.load_reader(metric)(_Run()), 100.0 * 2.5 / (3 * 2))


@pytest.mark.parametrize("metric", METRICS)
def test_none_where_there_is_nothing_to_read(monkeypatch, metric):
    loop = [("eval.accumulate", 1, S, 2 * S, None, 0)]
    _records(monkeypatch, [])
    assert run.load_reader(metric)(_Run()) is None
    _records(monkeypatch, loop)  # no decode: the parent's program
    assert run.load_reader(metric)(_Run()) is None
    _records(monkeypatch, [("loader.decode", 10, S, 2 * S, None, None)])  # no loop
    assert run.load_reader(metric)(_Run()) is None
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    assert run.load_reader(metric)(_Run()) is None
