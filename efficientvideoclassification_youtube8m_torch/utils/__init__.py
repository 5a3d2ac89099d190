"""Utilities: the config (utils/config.py) and the TensorBoard summaries
(utils/summary.py)."""
