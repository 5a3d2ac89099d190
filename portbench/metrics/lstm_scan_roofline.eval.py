"""lstm_scan_roofline.eval: the bf16 forward scan's bound time over the
device time of its kernel in the traced stretch, as %."""

from portbench.readers import roofline

KERNELS = ("lstm_step_kernel",)


def read(run):
    return roofline(run, KERNELS)
