"""loader_queue_wait_ms.lstm_eval: the milliseconds a batch the loader's
consumer waited for the readers to fill the oldest pinned block (the
program's `loader.queue_wait` spans over the traced stretch, per batch
accumulated): above 0 the readers are behind the loop."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms("loader.queue_wait")
