"""Hand-written kernels of the PyTorch port (``ops/cuda``), each beside
its plain PyTorch version."""
