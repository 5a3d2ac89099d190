"""host_metrics_ms.gnetvlad_eval: the milliseconds a batch the loop spent
on its fetched rows: unpacking, `accumulate_topk` over the 4716 classes
and the summary line (the program's `eval.accumulate` spans over the
traced stretch, per batch accumulated)."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms("eval.accumulate")
