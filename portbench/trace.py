"""The traced stretch of a `--trace 1` window: `torch.profiler` over the
CPU and the card, started and stopped by the driver's loop, reduced in
memory (no trace file) to what the per-layer readers and the result's
`breakdown` need: the device's busy time, device time and launches by
kernel name, and the longest idle gaps with what the host was doing.

The harness's own spans (`span(name)`, a `record_function`) mark the
calls into each layer from the benchmark's files; an idle gap is named
by the innermost span and the innermost host operation around its
middle."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."


@contextlib.contextmanager
def span(name: str, enabled: bool = True):
    if not enabled:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(event, f"{what}_us")() * 1000)


class Tracer:
    """Profiles the first `span` seconds of the window: `begin()` starts
    the profiler just before the window (starting it takes seconds, which
    would fall into the window), and `poll()`, called by the driver's loop
    on the main thread, stops it once `span` seconds have passed."""

    def __init__(self, device: torch.device, span: float):
        self.device = device
        self.span = span
        self.prof = None
        self.started = self.stopped = None
        self.summary: Optional[Dict] = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.stopped is None

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.started = time.perf_counter()

    def poll(self) -> None:
        if self.active and time.perf_counter() - self.started >= self.span:
            self.finish()

    def finish(self) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stopped = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> Optional[Dict]:
        """{"window_s", "busy_s", "kernels": {name: [launches, seconds]},
        "device_ops", "idle_gaps"} of the traced stretch, None if it
        never started."""
        if self.prof is None:
            return None
        self.finish()
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = _ns(e, "start"), _ns(e, "duration")
            kind = str(e.device_type()).split(".")[-1]
            if kind == "CUDA":
                # a span's range on the device's timeline is no device work
                if not e.name().startswith(SPAN_PREFIX):
                    device.append((start, start + dur, e.name()))
            elif kind == "CPU":
                host.append((start, start + dur, e.name()))
        kernels: Dict[str, List[float]] = {}
        for s, t, name in device:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (t - s) * 1e-9
        merged: List[Tuple[int, int]] = []
        for s, t, _ in sorted(device):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], t))
            else:
                merged.append((s, t))
        busy = sum(t - s for s, t in merged) * 1e-9
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:10]
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        self.summary = {
            "window_s": self.stopped - self.started,
            "busy_s": busy,
            "kernels": kernels,
            "device_ops": [[name, k[1]] for name, k in top],
            "idle_gaps": [[_host_label(host, (a + b) // 2), g * 1e-9]
                          for g, a, b in gaps],
        }
        self.prof = None
        return self.summary


def _host_label(host, t: int) -> str:
    """The innermost harness span and host operation around time t."""
    spans = [(e - s, n) for s, e, n in host if s <= t <= e and n.startswith(SPAN_PREFIX)]
    ops = [(e - s, n) for s, e, n in host if s <= t <= e and not n.startswith(SPAN_PREFIX)]
    label = min(spans)[1][len(SPAN_PREFIX):] if spans else "loop"
    return f"{label} > {min(ops)[1]}" if ops else label


def kernel_time(summary: Dict, patterns) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds any of
    `patterns`."""
    n, s = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if any(p in name for p in patterns):
            n += count
            s += secs
    return n, s
