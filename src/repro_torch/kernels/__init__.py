"""Kernels of the port: hand-written CUDA for Hopper (csrc/) behind thin
wrappers, each with its plain PyTorch version for CPU tensors."""
