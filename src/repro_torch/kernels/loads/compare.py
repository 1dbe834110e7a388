"""Time this checkout's ordered load sum on one card at the strategies'
shapes, against ``torch.bincount``, in one process.

    PYTHONPATH=src python3 -m repro_torch.kernels.loads.compare [--candidates] [--variants] [--profile] [--unit]

The cells are ``chip_smoke.py``'s: the multipod fabric's 102,400 flows
(64 x 64 hosts, 800 flows a pair), ``prime-spray`` over 64 seeds (H x
819,200 flowlets x 64 seeds, 1,024 links) with byte weights (alternating
2**20- and 2**30-byte flows, over K 8) and log-normal weights
(``exp(normal(0, 12))``, a seeded draw).  ``--unit`` adds unit weights at
the wave's round-0 shape (the ECMP walk, H x 102,400) and at
``prime-spray``'s, each over the first 64, 8 and 1 seeds, the kernel
against ``torch.bincount`` alone and with the keys and the weight a cell
it needs (``library_glue``).  Every sum of the kernel is held bit for bit
against the plain version on the CPU and against itself over two runs.
Times are medians of CUDA-event runs in rounds that alternate their
order.

``--candidates`` times the kernel with each seed's links split over
``CANDIDATES`` CTA clusters, ``--variants`` the copies of the source in
``VARIANTS`` and ``PROBES``.  ``--profile`` splits one run's SM cycles
into the kernel's phases (a ``-DLOADS_PROFILE`` build).
``tile_runs`` is the most, over seeds, of the sum over a seed's
4,096-row tiles of the tile's longest run: the adds of one tile wait for
that run, so ``tile_chain_floor_ms`` is the floor of adds that keep
step with the tiles; ``tile_thread_runs`` the same with the 4 keys of
one adding thread added one after another.  Prints one JSON object: the
card, each shape's bytes, bound, longest run and chain floor (longest run
x the float64 add latency that ``dadd_latency_probe`` measures), times and
checks.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import nvcc
from . import build, ops, ref

ROUNDS, REPS = 4, 5
HBM_BYTES_PER_S = 3.35e12
SEEDS, FLOWS_PER_PAIR, K = 64, 800, 8
#: link parts a seed (clusters of one seed group) the candidates time
CANDIDATES = (1, 2, 4)
#: seeds (the first of the 64) the unit-weight shapes are timed over
UNIT_SEEDS = (64, 8, 1)
#: copies of this checkout's source with one line changed
#: (``--variants``), built under ``_checkout/`` and timed at the default
#: block shape: ``stages2`` keeps 2 slot stages (not 4) between the ranking and
#: the adding warps, ``tile2048`` ranks 2,048 rows a tile, ``no_tma``
#: brings every share by 4-byte cp.async
VARIANTS = {
    "stages2": ("constexpr int STAGES = 4;", "constexpr int STAGES = 2;"),
    "tile2048": ("constexpr int TILE = 4096;", "constexpr int TILE = 2048;"),
    "no_tma": ("const bool tma = rows > 0", "const bool tma = false && rows > 0"),
}
#: diagnostic copies, timed but not meant to be right (``--variants``):
#: ``no_adds`` adds none of the slots (the ranking alone), ``no_weights``
#: loads no weight while ranking, ``no_match`` takes each lane as its own
#: group (one shared atomic a lane) where the chunk's keys differ
PROBES = {
    "no_adds": ("const int n = start[k + 1] - start[k];", "const int n = 0;"),
    "no_weights": ("key[e] != SKIP ? __ldg(p.w + n) : 0.0;", "1.0;"),
    "no_match": (": __match_any_sync(FULL, key[e]);", ": (1u << lane);"),
}
#: dependent adds the latency probe times
PROBE_STEPS = 1 << 16


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device ms of ``fn`` over ``reps`` event-timed runs after
    one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def alternating(fns: dict) -> dict:
    """Each of ``fns`` timed in ``ROUNDS`` rounds of alternating order:
    the median over rounds."""
    out = {name: [] for name in fns}
    for r in range(ROUNDS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            out[name].append(cuda_ms(fns[name]))
    return {name: sorted(v)[ROUNDS // 2] for name, v in out.items()}


def routes():
    """The smoke's fabric and flows, and the link ids of the ECMP walk
    and of ``prime-spray`` over ``SEEDS`` seeds, with the sprayed
    result's flow index."""
    import repro_torch.core as T
    comp = T.compile_fabric(T.build_multipod_fabric())
    flows = T.synthesize_flows(
        T.bipartite_pairs([f"host-{i}" for i in range(64)],
                          [f"host-{64 + i}" for i in range(64)],
                          FLOWS_PER_PAIR),
        nic_ip=T.nic_ip, nics_per_server=1)
    fm = T.flow_fields_matrix(flows, "5tuple")
    seeds = np.arange(SEEDS)
    ecmp = T.simulate_paths(comp, flows, seeds, field_matrix=fm,
                            hash_backend="murmur")
    spray = T.simulate_paths(comp, flows, seeds, strategy="prime-spray",
                             field_matrix=fm, hash_backend="murmur")
    return (comp.num_links, len(flows), ecmp.link_ids.contiguous(),
            spray.link_ids.contiguous(), spray.flow_index)


def weight_sets(n_flows: int, flow_index: torch.Tensor) -> dict:
    """The sprayed columns' byte weights and a log-normal draw."""
    b = np.where(np.arange(n_flows) % 2 == 0, 2.0**20, 2.0**30)
    byte = (torch.from_numpy(b / b.mean()).cuda()[flow_index] / K)
    rng = np.random.default_rng(26)
    lognormal = torch.from_numpy(np.exp(rng.normal(
        0, 12, flow_index.numel()))).cuda()
    return {"bytes": byte.contiguous(), "lognormal": lognormal}


def shape_facts(ids: torch.Tensor, L: int) -> dict:
    """Cells, bytes the function must move, both bounds, and the longest
    run (the most cells of one bin)."""
    H, N, S = ids.shape
    m = ids.numel()
    keep = (ids >= 0) & (ids < L)
    off = torch.arange(S, device=ids.device, dtype=torch.int64) * L
    keys = torch.where(keep, ids.long() + off, S * L).reshape(-1)
    runs = torch.bincount(keys, minlength=S * L + 1)[:S * L]
    # the hottest bin of each 4,096-row tile of each seed: a tile's adds
    # wait for its longest run
    tile = torch.arange(H * N, device=ids.device).reshape(H, N, 1) // 4096
    t_keys = torch.where(keep, (tile * S + torch.arange(
        S, device=ids.device)) * L + ids.long(), -1).reshape(-1)
    n_tiles = (H * N + 4095) // 4096
    counts = torch.bincount(t_keys[t_keys >= 0],
                            minlength=n_tiles * S * L).reshape(
                                n_tiles, S, L)
    del t_keys
    per_tile = counts.amax(2)
    # keys a + 256 j are one adding thread's, added one after another
    pad = (-L) % 256
    by_thread = torch.nn.functional.pad(counts, (0, pad)).reshape(
        n_tiles, S, -1, 256).sum(2).amax(2)
    del counts
    fn_bytes = m * 4 + N * 8 + S * L * 8
    return {"shape": [H, N, S], "links": L, "cells": m,
            "kept_cells": int(keep.sum()),
            "longest_run": int(runs.max()),
            "tile_runs": int(per_tile.sum(0).max()),
            "tile_thread_runs": int(by_thread.sum(0).max()),
            "bytes": fn_bytes, "bound_ms": fn_bytes / HBM_BYTES_PER_S * 1e3}


def dadd_latency() -> dict:
    """Cycles and ns of one dependent float64 add (one thread)."""
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    lib = build.load()
    for _ in range(2):                 # the first run warms the clock
        rc = lib.dadd_latency_probe(out.data_ptr(), PROBE_STEPS,
                                    torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"dadd_latency_probe failed with {rc}")
        torch.cuda.synchronize()
    cycles, ns = out[:2].tolist()
    return {"cycles": cycles / PROBE_STEPS, "ns": ns / PROBE_STEPS}


def held(ids, w, L, run=None) -> dict:
    """The kernel (or ``run``, a call of a build) against the plain
    version on the CPU, and itself."""
    run = run or (lambda: ops.ordered_cell_sum(ids, w, L))
    got = run().clone()
    again = run()
    want = ref.ordered_cell_sum_ref(ids.cpu(), w.cpu(), L)
    g = got.cpu()
    return {"bit_identical": bool(torch.equal(g, want)),
            "max_abs_err": float((g - want).abs().max()),
            "repeats": bool(torch.equal(got, again))}


def library(ids, w, L):
    """``torch.bincount`` on the card over (seed, link) keys and a weight
    a cell (its inputs, built once), and the same with those inputs built
    in the call (the glue the atomic branch of ``_cell_loads`` ran)."""
    H, N, S = ids.shape

    def inputs():
        off = torch.arange(S, device=ids.device, dtype=torch.int32) * L
        keys = torch.where(ids >= 0, ids + off, S * L).reshape(-1)
        return keys, w[None, :, None].expand(H, N, S).reshape(-1)

    keys, wc = inputs()
    wc = wc.contiguous()

    def with_glue():
        k, c = inputs()
        return torch.bincount(k, weights=c, minlength=S * L + 1)

    return keys, wc, (lambda: torch.bincount(keys, weights=wc,
                                             minlength=S * L + 1)), with_glue


def variant_libs(chosen: dict | None = None, *flags: str) -> dict:
    """``chosen`` (``VARIANTS`` and ``PROBES`` by default) built beside
    each other under ``_checkout/`` (one ``nvcc`` each, all at once),
    typed."""
    scratch = build.SOURCE.parents[5] / "_checkout"
    scratch.mkdir(exist_ok=True)
    # the copies include the shared header from where they lie
    text = build.SOURCE.read_text().replace(
        '#include "../../csrc/', f'#include "{build.SOURCE.parents[2]}/csrc/')
    srcs = {}
    for name, (old, new) in (chosen or {**VARIANTS, **PROBES}).items():
        if old and text.count(old) != 1:
            raise SystemExit(f"variant {name}: its lines are not once in "
                             f"the source")
        srcs[name] = scratch / f"loads_{name}.cu"
        srcs[name].write_text(text.replace(old, new))
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(lambda src: _build(src, *flags),
                                       srcs.values())))
    return {name: build.typed(ctypes.CDLL(str(lib)))
            for name, lib in libs.items()}


#: the phases of a ``-DLOADS_PROFILE`` build, in ``loads_profile``'s
#: order: the first ranking thread's, then the first adding thread's
RANKING = ("share_push", "col_wait", "rank", "hand_over", "slot_wait",
           "scan", "place")
ADDING = ("add_wait", "adds")


def profile(ids, w, L) -> dict:
    """Each phase's share of the first ranking thread's and the first
    adding thread's SM cycles, and the ranking cycles a CTA, from
    ``-DLOADS_PROFILE`` builds of this source and of its ``PROBES`` at
    the default block shape."""
    # their own names: a library already loaded under a path is reused
    libs = variant_libs({f"profile_{name}": change for name, change in
                         {"this": ("", ""), **PROBES}.items()},
                        "-DLOADS_PROFILE")
    out = {}
    for name, lib in libs.items():
        lib.loads_profile.argtypes = [ctypes.c_void_p]
        lib.loads_profile.restype = ctypes.c_int
        run = raw_runner(lib, ids, w, L)
        cycles = (ctypes.c_ulonglong * (len(RANKING) + len(ADDING)))()
        rc = lib.loads_profile(cycles)      # zero the totals
        if rc:
            raise RuntimeError(f"loads_profile failed with CUDA error {rc}")
        run()
        torch.cuda.synchronize()
        rc = lib.loads_profile(cycles)
        if rc:
            raise RuntimeError(f"loads_profile failed with CUDA error {rc}")
        ctas = -(-ids.shape[2] // 8) * 8 * (-(-L // ops.plan(L)))
        rk, ad = list(cycles)[:len(RANKING)], list(cycles)[len(RANKING):]
        out[name] = {"ranking_cycles_per_cta": sum(rk) / ctas,
                     "ranking": {k: c / sum(rk) for k, c in zip(RANKING, rk)},
                     "adding": {k: c / max(1, sum(ad))
                                for k, c in zip(ADDING, ad)}}
    return out


def raw_runner(lib, ids, w, L, lp: int | None = None):
    """A call of ``lib``'s entry point with ``lp`` links a CTA
    (``ops.plan``'s by default), into one output tensor it returns."""
    H, N, S = ids.shape
    out = torch.empty((S, L), dtype=torch.float64, device=ids.device)
    lp = lp or ops.plan(L)

    def run():
        rc = lib.ordered_cell_sum(ids.data_ptr(), w.data_ptr(),
                                  out.data_ptr(), H * N, N, S, L, lp,
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out
    return run


def _build(src: Path, *flags: str) -> Path:
    """``src`` built beside it, its ``-Xptxas -v`` report as ``.log``."""
    lib = src.with_suffix(".so")
    proc = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, *flags, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return lib


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib_path = build.build()
    L, n_flows, ecmp, spray, flow_index = routes()
    weights = weight_sets(n_flows, flow_index)
    out = {"card": smi, "ptxas": [
        ln.strip() for ln in lib_path.with_suffix(".log").read_text()
        .splitlines() if "registers" in ln or "spill" in ln],
        "dadd_latency": dadd_latency(), "spray": shape_facts(spray, L)}
    lat_ns = out["dadd_latency"]["ns"]
    floors(out["spray"], lat_ns)
    checks = {name: held(spray, w, L) for name, w in weights.items()}
    for name, w in weights.items():
        lib_sum = library(spray, w, L)[2]()[:spray.shape[2] * L]
        checks[f"library_bit_identical_{name}"] = bool(torch.equal(
            lib_sum.reshape(-1, L), ops.ordered_cell_sum(spray, w, L)))
        del lib_sum
    out["checks"] = checks
    w = weights["bytes"]
    fns = {"kernel": lambda: ops.ordered_cell_sum(spray, w, L),
           "library": library(spray, w, L)[2]}
    if "--candidates" in argv:
        lib = build.load()
        for p in CANDIDATES:
            run = raw_runner(lib, spray, w, L, math.ceil(L / p))
            out.setdefault("candidates_held", {})[f"parts{p}"] = held(
                spray, w, L, run)
            fns[f"parts{p}"] = run
    if "--variants" in argv:
        held_v = {}
        for name, lib in variant_libs().items():
            run = raw_runner(lib, spray, w, L)
            held_v[name] = {**held(spray, w, L, run), "ptxas": [
                ln.strip() for ln in Path(lib._name).with_suffix(".log")
                .read_text().splitlines() if "registers" in ln]}
            fns[f"variant_{name}"] = run
        out["variants_held"] = held_v
    if "--profile" in argv:
        try:
            out["profile"] = profile(spray, w, L)
        except RuntimeError as err:
            out["profile"] = str(err)
    out["spray"]["ms"] = alternating(fns)
    del fns
    if "--unit" in argv:
        out["unit"] = {}
        for name, whole, wu in (
                ("wave", ecmp, torch.ones(ecmp.shape[1], dtype=torch.float64,
                                          device="cuda")),
                ("prime-spray", spray, torch.full(
                    (spray.shape[1],), 1 / K, dtype=torch.float64,
                    device="cuda"))):
            for s in UNIT_SEEDS:
                ids = whole[:, :, :s].contiguous()
                facts = shape_facts(ids, L)
                floors(facts, lat_ns)
                facts["held"] = held(ids, wu, L)
                keys, wc, lib_u, glue_u = library(ids, wu, L)
                facts["library_bit_identical"] = bool(torch.equal(
                    lib_u()[:s * L].reshape(-1, L),
                    ops.ordered_cell_sum(ids, wu, L)))
                facts["ms"] = alternating({
                    "kernel": lambda ids=ids, wu=wu: ops.ordered_cell_sum(
                        ids, wu, L),
                    "library": lib_u, "library_glue": glue_u})
                del keys, wc, lib_u, glue_u, ids
                out["unit"][f"{name} S{s}"] = facts
    print(json.dumps(out))


def floors(facts: dict, lat_ns: float) -> None:
    """``facts``' chain floors at ``lat_ns`` an add."""
    facts["chain_floor_ms"] = facts["longest_run"] * lat_ns / 1e6
    facts["tile_chain_floor_ms"] = facts["tile_runs"] * lat_ns / 1e6


if __name__ == "__main__":
    main(sys.argv[1:])
