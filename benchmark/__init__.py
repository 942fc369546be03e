"""The benchmark of kstar_torch, the PyTorch and CUDA port (see README.md)."""
