"""The departure-ordered max-min drain of event timing: every seed's
whole drain as one cluster of CTAs over dense cell lists
(``csrc/drain.cu``)."""
