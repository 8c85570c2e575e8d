"""The benchmark of the PyTorch/CUDA port: one cell a run (see README.md)."""
