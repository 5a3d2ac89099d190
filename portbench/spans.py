"""What the readers of the program's own spans share (portbench/metrics/
`*_ms.eval`, `reader_busy.eval`): the span and counter totals, and the
span records, that the program's `utils.profiling` kept in this process
while the profiler ran, that is over the traced stretch of a `--trace 1`
window. A program without them (no `totals()` or `records()`, or no
batch accumulated) reads None."""

from __future__ import annotations

from typing import Dict, Optional


def totals() -> Optional[Dict]:
    try:
        from efficientvideoclassification_youtube8m_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "totals", None)
    return read() if read is not None else None


def per_batch_ms(name: str) -> Optional[float]:
    """Milliseconds of the span `name` a batch the loop accumulated
    (`eval.batches`), over the traced stretch."""
    t = totals()
    if t is None:
        return None
    batches = t["counters"].get("eval.batches", 0)
    span = t["spans"].get(name)
    if not batches or span is None:
        return None
    return 1e3 * span["seconds"] / batches


def busy_share(run, name: str) -> Optional[float]:
    """The span `name`'s seconds over the loader's reader threads
    (`num_readers`) times the loop's recorded stretch, as %. The stretch
    runs from the loop thread's first span (the thread of
    `eval.accumulate`) to its last, and each span is clipped to it: the
    profiler's switch turns on before its start and off after its stop,
    each of which can take seconds in which the readers go on recording
    but the loop does not."""
    try:
        from efficientvideoclassification_youtube8m_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    recs = read()
    loop = {r[1] for r in recs if r[0] == "eval.accumulate"}
    starts = [r[2] for r in recs if r[1] in loop]
    ends = [r[3] for r in recs if r[1] in loop]
    if not starts or max(ends) <= min(starts):
        return None
    lo, hi = min(starts), max(ends)
    busy = sum(max(0, min(r[3], hi) - max(r[2], lo)) for r in recs if r[0] == name)
    return 100.0 * busy / (int(run.flags["num_readers"]) * (hi - lo))
