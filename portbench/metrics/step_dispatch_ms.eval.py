"""step_dispatch_ms.eval: the milliseconds a batch the host spent
dispatching the eval step, not its device time (the program's
`step.eval` spans over the traced stretch, per batch accumulated)."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms("step.eval")
