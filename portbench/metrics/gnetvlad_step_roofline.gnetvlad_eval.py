"""gnetvlad_step_roofline.gnetvlad_eval: the least time of Gated
NetVLAD's eval forward (portbench/counts_gnetvlad.py, 0.259 ms at batch
256) times the steps launched in the traced stretch (the program's
`step.eval` spans), over the device seconds of every kernel traced there
but the copies and fills (`Memcpy`, `Memset`), as %: the whole step's
kernels (cuBLAS's products and PyTorch's own; the model has no kernel of
the port) against the forward's bound."""

from portbench import counts_gnetvlad
from portbench.spans import totals

NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    if run.trace is None or "widths" not in run.observed:
        return None
    t = totals()
    step = t["spans"].get("step.eval") if t is not None else None
    seconds = sum(s for name, (_, s) in run.trace["kernels"].items()
                  if not any(p in name for p in NOT_KERNELS))
    if step is None or not step["count"] or seconds <= 0:
        return None
    o = run.observed
    bound = counts_gnetvlad.bound_s(run.flags, o["widths"], o["batch"])
    return 100.0 * bound * step["count"] / seconds
