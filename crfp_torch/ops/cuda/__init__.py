"""Hand-written CUDA kernels for Hopper (sources in crfp_torch/csrc) and
their dispatchers: CPU tensors take the plain version, CUDA tensors the
kernel."""
