"""loader_assemble_ms.eval: the milliseconds a batch the loader's consumer
spent assembling batches (the program's `loader.assemble` spans over the
traced stretch, per batch accumulated)."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms("loader.assemble")
