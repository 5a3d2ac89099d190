"""Metrics: device-side top-k and PERR in torch (metrics/eval_util.py);
the host-side numpy metrics are the JAX package's, imported."""
