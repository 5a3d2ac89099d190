"""loader_queue_wait_ms.eval: the milliseconds a batch the loader's consumer
waited in its video queue's get() (the program's `loader.queue_wait` spans
over the traced stretch, per batch accumulated)."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms("loader.queue_wait")
