"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers, and
their plain PyTorch versions (``ref``)."""
