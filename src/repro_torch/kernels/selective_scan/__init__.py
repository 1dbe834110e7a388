"""Mamba-1's selective scan over time: a hand-written CUDA kernel
(``csrc/selective_scan.cu``) for the recurrence the JAX package runs as
one ``lax.scan`` in ``mamba1_forward``; no Pallas kernel computes it."""
