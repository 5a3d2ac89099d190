"""h2d_enqueue_ms.lstm_eval: the milliseconds a batch the host spent
enqueueing the 88 MB full-frame batch's host->device copy (the program's
`prefetch.h2d` spans over the traced stretch, per batch accumulated)."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms("prefetch.h2d")
