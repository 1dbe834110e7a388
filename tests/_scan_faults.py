"""Planted faults of the selective-scan kernel's source
(``kernels/selective_scan/csrc/selective_scan.cu``), each an (anchor,
replacement) pair: the anchor must stand in the source once
(``test_torch_mamba1.py`` checks it on the CPU), and the source built
with the replacement must break the row limit on the card
(``test_torch_gpu.py``).

- ``state_reset_each_tile``: the state set to 0 at each staged tile;
- ``c_one_step_late``: y_t taken with C of the step before (within a
  tile);
- ``stage_read_before_landed``: tile k scanned from the ring stage whose
  copies (tile k + 1's) were issued just before, not from tile k's.
"""

FAULTS = {
    "state_reset_each_tile": (
        "__syncthreads();  // tile k staged and converted; tile k - 1 consumed",
        "__syncthreads();\n    for (int n = 0; n < N; ++n) h[n] = 0.f;"),
    "c_one_step_late": (
        "reinterpret_cast<const float4*>(sC + j * N)[u]",
        "reinterpret_cast<const float4*>(sC + (j > 0 ? j - 1 : j) * N)[u]"),
    "stage_read_before_landed": (
        "smem + (k & 1) * Lay::XD;",
        "smem + ((k + 1) & 1) * Lay::XD;"),
}
