"""The departure-ordered max-min drain of event timing: every seed's
whole drain as one CUDA block (``csrc/drain.cu``)."""
