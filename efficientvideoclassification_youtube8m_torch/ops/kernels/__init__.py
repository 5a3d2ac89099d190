"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Importing these modules builds nothing: a kernel is compiled at its first
launch on a CUDA tensor (see _build.py).
"""
