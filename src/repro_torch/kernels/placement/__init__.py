"""Sequential congestion-aware placement: the greedy chain of the
``congestion-aware`` strategy and the wave's residue, as one CUDA kernel
with a warp per seed (``csrc/placement.cu``)."""
