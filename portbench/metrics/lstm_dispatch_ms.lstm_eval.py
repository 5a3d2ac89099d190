"""lstm_dispatch_ms.lstm_eval: the milliseconds a step the host spent in
the LSTM's stack and head (the program's `lstm.scan` and `lstm.head`
spans over the traced stretch, per `step.eval` span there): the dispatch
of their launches, not their device time."""

from portbench.spans import totals

SPANS = ("lstm.scan", "lstm.head")


def read(run):
    t = totals()
    if t is None:
        return None
    step = t["spans"].get("step.eval")
    found = [t["spans"][name]["seconds"] for name in SPANS if name in t["spans"]]
    if step is None or not step["count"] or not found:
        return None
    return 1e3 * sum(found) / step["count"]
