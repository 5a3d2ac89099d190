"""mfu.lstm_eval: the LSTM baseline's model FLOPs of the window's steps
(`portbench/counts_lstm.py`, every padded row-step) over the window's
seconds, as a share (%) of the H100's bf16 peak."""

from portbench import counts_lstm
from portbench.counts import BF16_FLOPS


def read(run):
    o = run.observed
    if not o.get("steps"):
        return None
    flops = counts_lstm.forward_flops(run.flags, o["batch"]) * o["steps"]
    return 100.0 * flops / run.window_s / BF16_FLOPS
