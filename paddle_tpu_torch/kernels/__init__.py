"""Kernels of the PyTorch port: each Hopper kernel sits beside its plain
PyTorch version, and the wrapper picks the plain version only for CPU
tensors."""
