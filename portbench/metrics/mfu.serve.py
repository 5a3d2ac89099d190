"""mfu.serve: the model FLOPs of the window's steps over its seconds, as a
share (%) of the H100's bf16 peak (portbench/counts.py)."""

from portbench.readers import peak_share


def read(run):
    return peak_share(run)
