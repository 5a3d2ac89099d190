"""The arithmetic the per-layer readers share (portbench/metrics/): each
returns None where its run holds nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence

from portbench import counts
from portbench.trace import kernel_time


def peak_share(run) -> Optional[float]:
    """Model FLOPs of the window's steps over its seconds, as % of the
    bf16 peak."""
    o = run.observed
    if not o["steps"]:
        return None
    flops = counts.step_flops(run.flags, run.work, o["batch"]) * o["steps"]
    return 100.0 * flops / run.window_s / counts.BF16_FLOPS


def roofline(run, patterns: Sequence[str]) -> Optional[float]:
    """The recurrence kernels' bound time over their device time in the
    traced stretch, as %: the launches of kernels named by `patterns`,
    over the launches a step makes, give the steps traced; each step's
    calls have their bounds (portbench/counts.py)."""
    if run.trace is None:
        return None
    launches, seconds = kernel_time(run.trace, patterns)
    if not launches or seconds <= 0:
        return None
    o = run.observed
    per_step = counts.step_kernel_launches(run.flags, run.work, o["batch"])
    bound_s = launches / per_step * counts.step_bound_ms(run.flags, run.work, o["batch"]) * 1e-3
    return 100.0 * bound_s / seconds


def idle_share(run) -> Optional[float]:
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def loader_wait_ms(run) -> Optional[float]:
    o = run.observed
    if "loader_wait_s" not in o or not o["steps"]:
        return None
    return 1e3 * o["loader_wait_s"] / o["steps"]


def median_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * statistics.median(values) if values else None
