"""Kernels of the port: hand-written CUDA kernels with plain PyTorch twins."""
