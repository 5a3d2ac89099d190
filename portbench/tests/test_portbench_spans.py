"""The readers of the program's own spans: None on an empty registry and
on a program without `totals()`, the right value on a synthetic one; and
a small traced run of `student_eval.b256` on the CPU reports every one
of them as a number."""

import json
import math
import time

import pytest
import torch

from portbench import run
from portbench.tests.small import resize

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
# (metric, the span it reads); reader_busy.eval is a share of the readers' time
PER_BATCH = [("loader_queue_wait_ms.eval", "loader.queue_wait"),
             ("loader_assemble_ms.eval", "loader.assemble"),
             ("h2d_enqueue_ms.eval", "prefetch.h2d"),
             ("step_dispatch_ms.eval", "step.eval"),
             ("fetch_wait_ms.eval", "fetch.wait"),
             ("host_metrics_ms.eval", "eval.accumulate")]
METRICS = [m for m, _ in PER_BATCH] + ["reader_busy.eval"]


class _Run:
    flags = {"num_readers": 4}
    trace = {"window_s": 2.0}


def _synthetic(monkeypatch, spans, counters):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    spans = {name: {"count": 1, "seconds": s, "self_seconds": s} for name, s in spans.items()}
    monkeypatch.setattr(profiling, "totals", lambda: {"spans": spans, "counters": counters})


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_is_none_on_an_empty_registry(metric):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    profiling.reset()
    assert run.load_reader(metric)(_Run()) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_is_none_without_the_programs_totals(monkeypatch, metric):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    monkeypatch.delattr(profiling, "totals")
    monkeypatch.delattr(profiling, "records")
    assert run.load_reader(metric)(_Run()) is None


@pytest.mark.parametrize("metric,span", PER_BATCH)
def test_a_per_batch_reader_on_a_synthetic_registry(monkeypatch, metric, span):
    _synthetic(monkeypatch, {span: 0.9, "other": 5.0}, {"eval.batches": 12})
    assert math.isclose(run.load_reader(metric)(_Run()), 75.0)
    _synthetic(monkeypatch, {span: 0.9}, {})
    assert run.load_reader(metric)(_Run()) is None


def test_reader_busy_on_synthetic_records(monkeypatch):
    """4 readers over a loop stretch of 2 s (from the loop thread's first
    span to its last): 6 s of parsing inside it, and a parse that runs on
    past the stretch counted only up to its end."""
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    s = 10 ** 9
    recs = [("loader.queue_wait", 1, 0, s, None, None), ("eval.accumulate", 1, s, 2 * s, None, 0)]
    recs += [("loader.parse", 10 + r, 0, s, None, None) for r in range(4)]
    recs += [("loader.parse", 10 + r, s, 3 * s // 2, None, None) for r in range(4)]
    recs.append(("loader.parse", 10, 2 * s - s // 2, 5 * s, None, None))
    monkeypatch.setattr(profiling, "records", lambda: recs)
    assert math.isclose(run.load_reader("reader_busy.eval")(_Run()), 100.0 * 6.5 / 8)
    monkeypatch.setattr(profiling, "records", lambda: recs[2:])  # no loop thread
    assert run.load_reader("reader_busy.eval")(_Run()) is None


def test_a_traced_run_reports_every_span_metric():
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    profiling.reset()
    result = run.run_cell(BENCH, "student_eval.b256", 2 ** 31 + 7, 1.0, True,
                          torch.device("cpu"), time.perf_counter, resize)
    assert result["correct"]
    for name in METRICS:
        value = result["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value) and value >= 0, name
    assert 0 < result["metrics"]["reader_busy.eval"]["value"] <= 100
    assert {m["name"] for m in BENCH["per_layer"]} >= set(METRICS)
