"""Ordered (seed, link) float64 load sums: the link-load tally of the
routing strategies in the CPU's summation order, as one CUDA kernel
(``csrc/loads.cu``)."""
