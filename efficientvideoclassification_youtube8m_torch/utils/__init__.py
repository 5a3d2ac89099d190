"""Utilities: the config (utils/config.py), the TensorBoard summaries
(utils/summary.py) and the profiler (utils/profiling.py)."""
