"""fetch_wait_ms.eval: the milliseconds a batch the loop waited for a step's
device->host copy (the program's `fetch.wait` spans over the traced
stretch, per batch accumulated): near 0 the host sets the pace."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms("fetch.wait")
