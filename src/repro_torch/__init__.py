"""repro_torch: the PyTorch and CUDA port of `repro` for one NVIDIA H100.

Module for module the counterpart of the JAX package, which stays the
reference. This package imports neither jax nor anything of `repro`.
"""

__version__ = "0.1.0"
