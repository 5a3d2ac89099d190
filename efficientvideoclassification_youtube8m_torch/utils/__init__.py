"""Utilities: the per-variable histogram summaries of the train loops
(utils/summary.py); the events-file writer is the JAX package's,
imported."""
