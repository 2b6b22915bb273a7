"""The benchmark of the PyTorch and CUDA port ``ndzip_tpu_torch``: ``run.py``
runs one cell of ``BENCHMARK.json``; see ``harness``."""
