"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the model's entry points to them (``ops``)."""
