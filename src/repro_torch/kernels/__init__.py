"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the backend switch between them (``dispatch``)."""
