"""gnetvlad_dispatch_ms.gnetvlad_eval: the milliseconds a step the host
spent in Gated NetVLAD's forward (the program's `gnetvlad.video`,
`gnetvlad.audio`, `gnetvlad.hidden` and `gnetvlad.head` spans over the
traced stretch, per `step.eval` span there): the dispatch of its
launches, not their device time."""

from portbench.spans import totals

SPANS = ("gnetvlad.video", "gnetvlad.audio", "gnetvlad.hidden", "gnetvlad.head")


def read(run):
    t = totals()
    if t is None:
        return None
    step = t["spans"].get("step.eval")
    found = [t["spans"][name]["seconds"] for name in SPANS if name in t["spans"]]
    if step is None or not step["count"] or not found:
        return None
    return 1e3 * sum(found) / step["count"]
