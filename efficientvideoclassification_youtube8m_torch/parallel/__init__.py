"""Parallel: the single-process subset of the JAX package's
parallel/distributed.py that the binaries need (parallel/distributed.py).
Data-parallel, multi-host and sequence-parallel runs are ROADMAP Queue 1,
parallel and orbax."""
