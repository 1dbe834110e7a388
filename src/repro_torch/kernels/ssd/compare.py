"""Time this checkout's SSD intra-chunk kernel against other builds of
``ssd.cu`` on one card, in one process and in alternating rounds.

    git show <rev>:src/repro_torch/kernels/ssd/csrc/ssd.cu > _checkout/old.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.ssd.compare _checkout/old.cu [...]

(``_checkout/`` is gitignored.)  Every build runs bf16 at mamba2-1.3b's
serving shape (B 2, 64 heads, S 32,768, N 128, hd 64, Q 256) on
``ref.ssd_inputs`` and must keep this entry point's signature; an
edited copy of this checkout's source finds ``kernels/csrc/hopper.cuh``
through ``-I``.  Prints the card, each build's row errors against the
plain version and the median ms of each over rounds that alternate
their order.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from .. import nvcc
from . import build, ref

ROUNDS, REPS = 6, 5
#: batch rows and tokens of the serving prefill, mamba2-1.3b's chunk
B, S, Q = 2, 32_768, 256


def cuda_ms(fn, reps: int) -> float:
    """Median device ms of ``fn`` over ``reps`` CUDA-event-timed runs,
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def _load(src: Path):
    """The ``ssd_intra_chunk`` entry point of ``src`` built beside it."""
    lib = src.with_suffix(".so")
    subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I",
                    str(build.SOURCE.parent), "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    return build.typed(ctypes.CDLL(str(lib))).ssd_intra_chunk


def main(others: list[str]) -> None:
    args = ref.ssd_chunks(*ref.ssd_inputs(B, S, torch.bfloat16, 21), Q)
    a, d, b, c, xk = args
    _, H, nc, _, hd = xk.shape
    N = b.shape[-1]
    y = torch.empty((B, nc, Q, H, hd), dtype=xk.dtype,
                    device="cuda").permute(0, 3, 1, 2, 4)
    s_loc = torch.empty((B, H, nc, N, hd), dtype=torch.float32, device="cuda")
    dec = torch.empty((B, H, nc, 1, 1), dtype=torch.float32, device="cuda")

    def runner(fn):
        def run():
            rc = fn(a.data_ptr(), d.data_ptr(), b.data_ptr(), c.data_ptr(),
                    xk.data_ptr(), y.data_ptr(), s_loc.data_ptr(),
                    dec.data_ptr(), 1, B, H, nc, Q, N, hd, *a.stride()[:4],
                    *d.stride()[:4], *b.stride()[:3], *c.stride()[:3],
                    *xk.stride()[:4], *y.stride()[:4],
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed with CUDA error {rc}")
            return y, s_loc, dec
        return run

    # every build through the same raw call into the same outputs, so no
    # build pays the wrapper's host time inside its events
    runs = {"this": runner(build.load().ssd_intra_chunk)}
    for other in others:
        runs[other] = runner(_load(Path(other).resolve()))
    want = ref.ssd_intra_chunk_ref(*args)
    errs = {}
    for name, run in runs.items():
        got = run()
        errs[name] = {k: float(ref.row_errors(g, w).max())
                      for k, g, w in zip(("y", "s_loc"), got, want)}
    del want
    times = {name: [] for name in runs}
    for r in range(ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[name].append(cuda_ms(runs[name], REPS))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "max_row_err": errs,
                      "median_ms": {k: sorted(v)[ROUNDS // 2]
                                    for k, v in times.items()},
                      "ms": times}))


if __name__ == "__main__":
    main(sys.argv[1:])
