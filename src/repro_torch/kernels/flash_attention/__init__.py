"""Flash-attention forward: the port of the JAX package's Pallas
flash-attention kernel, as a CUDA kernel (``csrc/flash_attention.cu``)."""
