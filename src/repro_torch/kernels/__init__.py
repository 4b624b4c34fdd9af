"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the dispatchers that choose between them."""
