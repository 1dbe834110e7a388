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

#: Planted faults of the backward kernel (``selective_scan_bwd`` in the same
#: source), each (anchor, replacement, what it must do on the card): "limit"
#: must break ``ref.BWD_RTOL`` against the plain version, "bits" must change
#: the bits of the kernel's result (its sums in another order) and keep it
#: within the limit.
#:
#: - ``state_carry_dropped``: phase 1 saves zeros, so each tile is replayed
#:   from a zero state, not the state before it;
#: - ``g_carry_dropped``: the carry g set to 0 as each tile's walk starts;
#: - ``partials_order_swapped``: each block's warps' partial sums of dB and
#:   dC added last warp first.
BWD_FAULTS = {
    "state_carry_dropped": (
        "        st4(dst, h);\n        st4(dst + 4, h + 4);",
        "        const float z[HALF] = {};\n"
        "        st4(dst, z);\n        st4(dst + 4, z + 4);",
        "limit"),
    "g_carry_dropped": (
        "    lane_st(Lay::STARTS, saved);        // sub-tile 0's start",
        "    lane_st(Lay::STARTS, saved);\n"
        "    for (int n = 0; n < HALF; ++n) g[n] = 0.f;",
        "limit"),
    "partials_order_swapped": (
        "        for (int wp = 0; wp < BWD_WARPS; ++wp) {",
        "        for (int wp = BWD_WARPS - 1; wp >= 0; --wp) {",
        "bits"),
}

#: The backward's block past D (the grid rounds up to whole clusters)
#: pointed at its own first channel, past D, instead of the last: it copies
#: the chunk that holds each row's first byte, and in the last step of the
#: last batch row that chunk lies past x's end.  On inputs that end where
#: their mapped memory ends (``tests/_guarded_scan.py``) the launch must
#: fault.
BWD_READ_FAULT = ("  const int cr = min(c0, D - 1);",
                  "  const int cr = c0;")
