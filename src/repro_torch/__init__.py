"""repro_torch — the Jiagu control plane ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``, module for module:
``repro_torch/core/predictor.py`` is the port of
``repro/core/predictor.py``, and so on.  The forest kernels that the
reference writes in Pallas for the TPU are hand-written CUDA for Hopper
under ``kernels/csrc/``.  The package imports torch and numpy only,
never jax and never a module of ``repro``.

Inference engines are ``("numpy", "torch", "cuda")``: the numpy host
oracle, the plain PyTorch version on the device the caller names, and
the hand-written kernels.  Entry points run on the card unless the
caller asks for the CPU (``device="cpu"``) or for ``engine="numpy"``.
"""
