"""vlad_dispatch_ms.vlad_eval: the milliseconds a batch the host spent in
NeXtVLAD's forward (the program's `nextvlad.video`, `nextvlad.audio` and
`nextvlad.gate` spans over the traced stretch, per batch accumulated):
the dispatch of its launches, not their device time."""

from portbench.spans import totals

SPANS = ("nextvlad.video", "nextvlad.audio", "nextvlad.gate")


def read(run):
    t = totals()
    if t is None:
        return None
    batches = t["counters"].get("eval.batches", 0)
    found = [t["spans"][name]["seconds"] for name in SPANS if name in t["spans"]]
    if not batches or not found:
        return None
    return 1e3 * sum(found) / batches
