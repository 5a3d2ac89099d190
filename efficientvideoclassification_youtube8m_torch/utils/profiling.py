"""Tracing and step timing (port of the JAX package's utils/profiling.py).

The reference's only observability is wall-clock deltas turned into
examples/sec summaries (`train.py:513-521,542-544`); the binaries keep
those. Beside them:

  * `trace(logdir)`: `torch.profiler` around the enclosed steps (CUDA
    activity when the device is the card) writing a Chrome trace
    (chrome://tracing, Perfetto) into `logdir`;
  * `annotate(name)`: a named range of host work on that trace, and an
    NVTX range for a CUDA-side tool;
  * `StepTimer`: rolling step-time statistics with the examples/sec the
    reference logs, and p50/p90 for the tail.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


class Trace:
    """What `trace` yields: the running `torch.profiler.profile`
    (`profile`, for `key_averages()` and the like) and, once the block
    has ended, the path of the Chrome trace it wrote (`path`)."""

    def __init__(self, profile):
        self.profile = profile
        self.path: Optional[str] = None


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the enclosed steps with `torch.profiler` and write the
    Chrome trace `trace.<pid>.<ms>.json` into `logdir`. CUDA activity is
    recorded when `device` is a CUDA device, or, with no device, when
    CUDA is available."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        result = Trace(prof)
        yield result
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    result.path = path


@contextlib.contextmanager
def annotate(name: str):
    """A named range around host work: a `record_function` on the
    profiler's trace and, where CUDA is available, an NVTX range."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Rolling per-step wall-clock stats."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, examples: int) -> float:
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return examples / dt

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "p50_ms": ts[n // 2] * 1e3,
            "p90_ms": ts[min(n - 1, int(n * 0.9))] * 1e3,
            "mean_ms": sum(ts) / n * 1e3,
        }
