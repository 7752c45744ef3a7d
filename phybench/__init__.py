"""phybench: the benchmark of the PyTorch + CUDA port of the LTE PHY."""
