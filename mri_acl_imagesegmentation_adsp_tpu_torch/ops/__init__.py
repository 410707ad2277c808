"""Tensor ops of the port: k-space transforms, the complex host boundary,
image ops, mask ops, and the hand-written CUDA kernels under ``kernels/``."""
