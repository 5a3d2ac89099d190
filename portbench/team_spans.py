"""What `decode_busy.*` read: the share of the native batcher's team's time
spent in one of its spans, from the span records that the program's
`utils.profiling` kept while the profiler ran (the traced stretch of a
`--trace 1` window). Where `portbench/spans.busy_share` divides by the
loader's `num_readers`, this divides by the threads that recorded the
span, which the program sizes from the host's CPUs. A program without
such records reads None."""

from __future__ import annotations

from typing import Optional


def team_busy_share(name: str) -> Optional[float]:
    """The span `name`'s seconds over the number of distinct threads that
    recorded it inside the loop's recorded stretch times that stretch, as
    %. The stretch runs from the loop thread's first span (the thread of
    `eval.accumulate`) to its last, and each span is clipped to it, as in
    `busy_share`."""
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
    busy = {}
    for r in recs:
        if r[0] == name and min(r[3], hi) > max(r[2], lo):
            busy[r[1]] = busy.get(r[1], 0) + min(r[3], hi) - max(r[2], lo)
    if not busy:
        return None
    return 100.0 * sum(busy.values()) / (len(busy) * (hi - lo))
