"""The benchmark of the PyTorch and CUDA port (``crfp_torch``): one command
runs one cell of ``BENCHMARK.json`` (``benchmark/run.py``)."""
