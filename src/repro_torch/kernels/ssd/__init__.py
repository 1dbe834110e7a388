"""Mamba-2 SSD within a chunk: the port of the JAX package's Pallas
``ssd_intra_chunk`` kernel, as a CUDA kernel (``csrc/ssd.cu``)."""
