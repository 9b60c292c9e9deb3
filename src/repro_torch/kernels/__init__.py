"""Kernels of the port: hand-written CUDA for Hopper, each beside its plain
PyTorch version (``ref``), dispatched by ``ops``."""
