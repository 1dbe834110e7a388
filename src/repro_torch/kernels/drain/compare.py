"""Time this checkout's departure-drain kernel against another build of
``drain.cu`` with the first design's entry point, on one card, in one
process and in alternating rounds.

    mkdir -p _checkout
    git show 021c050:src/repro_torch/kernels/drain/csrc/drain.cu > _checkout/drain_first.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.drain.compare _checkout/drain_first.cu [--clusters 1 2 4 8]

(``_checkout/`` is gitignored.)  The inputs are the drain's at the
widest step of ``chip_smoke.py``'s full-width ECMP and ``prime-spray``
drives (the MoE all-to-all: 4,096 and 32,768 columns x 64 seeds, 1,024
links, 4 hops), made by driving both.  Each call is the whole wrapper
(its preparation, the launch, the read of its statistics); the other
build goes through a copy of the first design's wrapper.  ``--clusters``
adds this checkout's kernel at forced cluster sizes (``ops.plan``'s
``cluster``) beside its plan's; ``--profile`` then runs each of this
checkout's variants once more from a ``-DDRAIN_PROFILE`` build of its
source and prints each phase's share of rank 0's SM cycles (the fill's
sums, shares, bottleneck pass, freeze pass, horizon, departures) and
cycles a seed.  Prints the card, the plans, the
cluster-reduction probe's ms at each plan, each build's largest relative
difference from this checkout's plan (and at ECMP's shape from the plain
version), rounds, and the median ms of each over rounds that alternate
their order, with the µs a freeze round.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import nvcc
from . import build, ops
from .ref import departure_drain_ref

ROOT = Path(__file__).resolve().parents[4]
#: alternating rounds and timed runs a round, per shape (the first
#: design takes about 4 s a call at prime-spray's)
ROUNDS = {"ecmp": (6, 3), "prime-spray": (4, 1)}


def _load_first_design(src: Path):
    """The ``departure_drain`` entry point of ``src`` (the first design's
    signature) built beside it."""
    lib = src.with_suffix(".so")
    subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).departure_drain
    p = ctypes.c_void_p
    fn.argtypes = [p] * 13 + [ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def _build(src: Path, *flags: str) -> ctypes.CDLL:
    """``src`` (this design's entry points) built beside it, typed."""
    lib = src.with_suffix(".so")
    proc = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, *flags, "-I",
                           str(build.SOURCE.parent), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return build.typed(ctypes.CDLL(str(lib)))


def _this_design(lib: ctypes.CDLL):
    """``ops.departure_drain`` launching ``lib`` (another build of this
    design's source)."""
    def run(*args):
        real = build.load
        build.load = lambda: lib
        try:
            return ops.departure_drain(*args)
        finally:
            build.load = real
    return run


def _first_design(fn):
    """The first design's wrapper around ``fn``: int32 links, a block
    per seed, four float64 and one byte of scratch a cell."""
    def run(cells, seed, S, cap, gbits, eff, w, init, max_rounds):
        H, A = cells.shape
        dev, f64 = cells.device, torch.float64
        L = cap.numel()
        links = torch.where(cells < S * L, cells - seed * L, -1).to(
            torch.int32).contiguous()
        seg = torch.zeros(S + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(seed, minlength=S), 0, out=seg[1:])
        scratch = [torch.empty(A, dtype=f64, device=dev) for _ in range(4)]
        st = torch.empty(A, dtype=torch.uint8, device=dev)
        stats = torch.zeros((S, 4), dtype=torch.int64, device=dev)
        rem, rate, fm, done = scratch
        rc = fn(links.data_ptr(), seg.data_ptr(), cap.data_ptr(),
                gbits.data_ptr(), eff.data_ptr(),
                0 if w is None else w.data_ptr(),
                0 if init is None else init.data_ptr(), rem.data_ptr(),
                rate.data_ptr(), fm.data_ptr(), st.data_ptr(),
                done.data_ptr(), stats.data_ptr(), A, int(max_rounds), H, L,
                S, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        stats = stats.cpu()
        if int(stats[:, 3].max()):
            raise RuntimeError(f"the first design faulted: {stats[:, 3]}")
        return ops.Drain(done, int(stats[:, 0].max()), int(stats[:, 1].max()),
                         int(stats[:, 2].sum()))
    return run


PHASES = ("fill_sums", "shares", "bottleneck", "freeze", "horizon",
          "departures")


def _profile(runs: dict, args: tuple, S: int) -> dict:
    """Each phase's share of this checkout's variants' SM cycles, and
    the cycles a seed, from a ``-DDRAIN_PROFILE`` build."""
    copy = ROOT / "_checkout" / "drain_profile.cu"
    copy.parent.mkdir(exist_ok=True)
    copy.write_bytes(build.SOURCE.read_bytes())
    prof = _build(copy, "-DDRAIN_PROFILE")
    real, out = build.load, {}
    build.load = lambda: prof
    try:
        for name, run in runs.items():
            if name.startswith("this"):
                cyc = run(*args).phases
                tot = sum(cyc)
                out[name] = {"cycles_per_seed": tot / S,
                             **{k: c / tot for k, c in zip(PHASES, cyc)}}
    finally:
        build.load = real
    return out


def main(argv: list[str]) -> None:
    cli = argparse.ArgumentParser()
    cli.add_argument("others", nargs="*", help="drain.cu files of the first "
                     "design's entry point")
    cli.add_argument("--clusters", nargs="*", type=int, default=[])
    cli.add_argument("--profile", action="store_true")
    cli.add_argument("--variants", nargs="*", default=[],
                     help="drain.cu files of this design's entry point")
    a = cli.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    shapes = cs.widest_drains(np, torch)
    others = {other: _first_design(_load_first_design(Path(other).resolve()))
              for other in a.others}
    variants = {v: _this_design(_build(Path(v).resolve()))
                for v in a.variants}
    out = {}
    for shape, args in shapes.items():
        cells, S, cap = args[0], args[2], args[3]
        H, A = cells.shape
        per_seed = int(torch.bincount(args[1], minlength=S).max())
        plans = {"this": ops.plan(S, per_seed, cap.numel(), H)}
        runs = {"this": lambda *args: ops.departure_drain(*args)}
        for c in a.clusters:           # the forced sizes this shape fits
            try:
                pl = ops.plan(S, per_seed, cap.numel(), H, cluster=c)
            except ValueError:
                continue
            plans[f"this, cluster {c}"] = pl
            runs[f"this, cluster {c}"] = (
                lambda *args, c=c: ops.departure_drain(*args, cluster=c))
        runs.update(others)
        runs.update(variants)
        results = {name: run(*args) for name, run in runs.items()}
        base = results["this"].done
        rel = {name: float(((r.done - base).abs()
                            / base.abs().clamp(min=1e-300)).max())
               for name, r in results.items()}
        if shape == "ecmp":
            want = departure_drain_ref(*args)[0]
            rel["plain version"] = float(
                ((base - want).abs() / want.abs().clamp(min=1e-300)).max())
        rounds, reps = ROUNDS.get(shape, (4, 1))
        times = {name: [] for name in runs}
        for r in range(rounds):
            for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[name].append(cs.cuda_ms(lambda: runs[name](*args),
                                              reps))
        med = {k: sorted(v)[rounds // 2] for k, v in times.items()}
        out[shape] = {
            "shape": [H, A, S, cap.numel()], "per_seed": per_seed,
            "plans": {k: vars(v) for k, v in plans.items()},
            "probe_ms": {k: ops.sync_probe_ms(v, S, cap.numel())
                         for k, v in plans.items()},
            "max_rel_diff": rel,
            "rounds": {k: [r.rounds, r.fill_rounds, r.chain]
                       for k, r in results.items()},
            "median_ms": med,
            "us_per_freeze_round": {
                k: med[k] * 1e3 / max(results[k].fill_rounds, 1)
                for k in runs},
            "ms": times}
        if a.profile:
            out[shape]["phase_share"] = _profile(runs, args, S)
        print(json.dumps({shape: out[shape]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi,
                      "median_ms": {k: v["median_ms"] for k, v in out.items()},
                      "us_per_freeze_round": {
                          k: v["us_per_freeze_round"]
                          for k, v in out.items()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
