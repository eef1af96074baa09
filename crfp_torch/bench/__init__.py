"""Latency harness of the port on the GPU."""
