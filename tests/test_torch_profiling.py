"""The port's profiler helpers (utils/profiling.py) on the CPU:
`StepTimer` against the JAX package's for the same step times, `trace`
writing a Chrome trace that holds an `annotate` range, and `annotate`
without a CUDA device."""

import json
import os

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.utils import profiling as jprofiling
from efficientvideoclassification_youtube8m_torch.utils import profiling


class _Clock:
    """A perf_counter that steps through the given times."""

    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


@pytest.mark.parametrize("window", [3, 100])
def test_step_timer_matches_jax(monkeypatch, window):
    rng = np.random.default_rng(0)
    durations = rng.uniform(0.01, 0.5, size=12)
    starts = np.cumsum(rng.uniform(0.0, 1.0, size=12))
    ticks = [t for s, d in zip(starts, durations) for t in (float(s), float(s + d))]
    rates = {}
    for name, module in (("port", profiling), ("jax", jprofiling)):
        monkeypatch.setattr(module.time, "perf_counter", _Clock(ticks))
        timer = module.StepTimer(window=window)
        assert timer.stats() == {}
        got = []
        for _ in durations:
            timer.start()
            got.append(timer.stop(examples=256))
        rates[name] = (got, timer.stats())
    assert rates["port"] == rates["jax"]
    assert set(rates["port"][1]) == {"p50_ms", "p90_ms", "mean_ms"}


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as t:
        with profiling.annotate("input_pipeline"):
            torch.ones(64).sum()
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert t.path is not None and os.path.dirname(t.path) == str(tmp_path / "trace")
    events = json.load(open(t.path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "input_pipeline" in names
    assert any("mm" in str(n) for n in names)
    assert any(e.key == "input_pipeline" for e in t.profile.key_averages())


def test_annotate_runs_outside_a_trace():
    with profiling.annotate("host work"):
        x = torch.arange(4).sum()
    assert int(x) == 6
