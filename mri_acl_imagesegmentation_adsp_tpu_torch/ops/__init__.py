"""Tensor ops of the port: k-space transforms, image ops, mask ops, and the
hand-written CUDA kernels under ``kernels/``."""
