"""mfu.vlad_eval: NeXtVLAD's model FLOPs of the window's steps
(portbench/counts_vlad.py at the widths the driver observed) over the
window's seconds, as a share (%) of the H100's bf16 peak."""

from portbench import counts_vlad
from portbench.counts import BF16_FLOPS


def read(run):
    o = run.observed
    if not o.get("steps") or "widths" not in o:
        return None
    flops = counts_vlad.forward_flops(run.flags, o["widths"], o["batch"]) * o["steps"]
    return 100.0 * flops / run.window_s / BF16_FLOPS
