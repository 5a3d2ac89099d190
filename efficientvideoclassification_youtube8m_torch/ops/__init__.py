"""Compute primitives: preprocessing, the plain LSTM scan (ops.lstm) and
the hand-written CUDA kernels with their wrappers (ops.kernels)."""
