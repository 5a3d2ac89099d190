"""vlad_step_roofline.vlad_eval: the least time of NeXtVLAD's eval forward
(portbench/counts_vlad.py) times the batches the loop accumulated in the
traced stretch (the program's `eval.batches`), over the device seconds of
every kernel traced there but the copies and fills (`Memcpy`, `Memset`),
as %: the whole step's kernels against the forward's bound."""

from portbench import counts_vlad
from portbench.spans import totals

NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    if run.trace is None or "widths" not in run.observed:
        return None
    t = totals()
    batches = t["counters"].get("eval.batches", 0) if t is not None else 0
    seconds = sum(s for name, (_, s) in run.trace["kernels"].items()
                  if not any(p in name for p in NOT_KERNELS))
    if not batches or seconds <= 0:
        return None
    o = run.observed
    return 100.0 * counts_vlad.bound_s(run.flags, o["widths"], o["batch"]) * batches / seconds
