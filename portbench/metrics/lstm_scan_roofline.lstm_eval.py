"""lstm_scan_roofline.lstm_eval: the bf16 scan kernel's least time on a
300-step layer of the cell (`portbench/counts_lstm.scan_bound_ms`, 0.651
ms at batch 256) times the scan calls launched in the traced stretch
(the program's `lstm.step_launches`, which the scan's wrapper adds a
call's steps to, over `max_num_frames`), over the device seconds of its kernel
(`lstm_step_kernel`) traced there, as %."""

from portbench import counts_lstm
from portbench.spans import totals
from portbench.trace import kernel_time

KERNELS = ("lstm_step_kernel",)


def read(run):
    if run.trace is None:
        return None
    t = totals()
    steps = t["counters"].get("lstm.step_launches", 0) if t is not None else 0
    _, seconds = kernel_time(run.trace, KERNELS)
    if not steps or seconds <= 0:
        return None
    calls = steps / run.flags["max_num_frames"]
    bound_s = calls * counts_lstm.scan_bound_ms(run.flags, run.observed["batch"]) * 1e-3
    return 100.0 * bound_s / seconds
