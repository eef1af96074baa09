"""Tensor ops of the port, NCHW; the plain PyTorch versions of the kernels."""
