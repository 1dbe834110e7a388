"""Hand-written Hopper kernels of the port, one package per family, each
with ``ops.py`` (the wrappers), ``ref.py`` (the plain PyTorch version)
and its CUDA source under ``csrc/``."""
