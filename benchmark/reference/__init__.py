"""The plain reference the benchmark holds the port against: plain
PyTorch, float32, no kernels; it imports nothing of the port."""
