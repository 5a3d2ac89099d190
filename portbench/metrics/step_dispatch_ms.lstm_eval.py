"""step_dispatch_ms.lstm_eval: the milliseconds a batch the host spent
dispatching the LSTM baseline's eval step, its 600 scan-kernel launches
included, not its device time (the program's `step.eval` spans over the
traced stretch, per batch accumulated)."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms("step.eval")
