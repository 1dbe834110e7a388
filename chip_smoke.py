#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any
card with ``nvcc`` for ``sm_90a``).  It builds the flow-hash kernel from
``src/repro_torch/kernels/flowhash/csrc/flowhash.cu`` and then:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds every kernel wrapper against its plain PyTorch version on the
   card, bit for bit, at the main path's shapes, checks the JAX
   package's pinned flow-hash values, and times kernel and plain
   version with CUDA events;
3. anchors the port on the paper testbed (256 flows x 1,024 seeds):
   aggregate FIM mean and mean max-min rate under both hash backends
   must match the JAX package's numpy-engine values to 1e-9 relative;
4. drives the main path at full scale — the default multipod fabric
   (144 devices, 1,024 links) with 102,400 bipartite pod-to-pod flows:
   ``monte_carlo_fim`` over 10,240 seeds, ``monte_carlo_throughput``
   over 1,024 seeds and the paper's four-stage ``simulate_paper_paths``
   — with every kernel's launch count set to 0 just before and read
   just after — and checks its first two seeds against the CPU path;
5. prints the ``kernels`` record and, last, the one-line result.

Every check raises, so any failure exits non-zero before the result
line.  Without a CUDA card, or without the repository around it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit ALU peak outside the tensor cores
#: integer operations of the murmur chain: per field fold, and fmix
FOLD_OPS, FMIX_OPS = 9, 8

# The JAX package's numpy-engine values on the paper testbed (256
# bipartite flows, seeds 0..1023): aggregate FIM mean, mean flow rate.
ANCHORS = {
    "exact": (32.53364562988281, 18.45605006788607),
    "murmur": (32.590484619140625, 18.449603870457246),
}
ANCHOR_RTOL = 1e-9
# tests/test_kernels.py pins these for the Pallas bulk_hash kernel:
# rng(42) fields (4096, 5) below 2**31, seed 12345
PINNED_HEAD = [1282828036, 453300701, 462728589, 1920719609]
PINNED_SUM = 8712584361707

GRID_FLOWS, GRID_SEEDS, N_FIELDS = 102_400, 2_560, 5
FIM_SEEDS, TP_SEEDS = 10_240, 1_024
FLOWS_PER_PAIR = 800           # 128 directed host pairs -> 102,400 flows


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms over ``reps`` event-timed
    runs, after one warm-up run."""
    import torch
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
    times.sort()
    return times[len(times) // 2]


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from repro_torch.kernels.flowhash import build
    t0 = time.perf_counter()
    lib = build.build()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    build.load()
    emit({"phase": "build", "library": lib.name,
          "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def phase_kernels(np, torch):
    """Each wrapper against its plain version at the main path's shape;
    returns the kernel records (launch counts filled in later)."""
    from repro_torch.kernels.flowhash import ops, ref
    rng = np.random.default_rng(2024)
    fields = torch.from_numpy(rng.integers(
        0, 2**32, (GRID_FLOWS, N_FIELDS), dtype=np.uint64
    ).view(np.int64)).cuda()
    dev_seed = torch.from_numpy(rng.integers(
        0, 2**64, (GRID_FLOWS, GRID_SEEDS), dtype=np.uint64
    ).view(np.int64)).cuda()
    records = []

    # the walk's per-(flow, seed) grid (bulk_hash_seeded_kernel's chain)
    got = ops.murmur_hash_grid(fields, dev_seed)
    want = ref.murmur_hash_grid_ref(fields, dev_seed)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want), "murmur_hash_grid != plain version")
    del got, want
    seeded = torch.from_numpy(rng.integers(
        0, 2**32, GRID_FLOWS, dtype=np.uint64).view(np.int64)).cuda()
    check(torch.equal(ops.bulk_hash_seeded(fields, seeded),
                      ref.murmur_hash_grid_ref(fields, seeded[:, None])[:, 0]),
          "bulk_hash_seeded != plain version")
    cells = GRID_FLOWS * GRID_SEEDS
    b_ms, b_by = bound(fields.numel() * 8 + 2 * cells * 8,
                       cells * (N_FIELDS * FOLD_OPS + FMIX_OPS))
    records.append({
        "name": "murmur_hash_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/flowhash/csrc/flowhash.cu",
        "replaces": "src/repro/kernels/flowhash/kernel.py:90",
        "shape": [GRID_FLOWS, N_FIELDS, GRID_SEEDS],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.murmur_hash_grid(fields, dev_seed), 20),
        "plain_ms": cuda_ms(
            lambda: ref.murmur_hash_grid_ref(fields, dev_seed), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    del dev_seed

    # one scalar seed broadcast over the rows (bulk_hash_kernel)
    got = ops.bulk_hash(fields, 12345)
    init = torch.full((GRID_FLOWS, 1), 12345, dtype=torch.int64,
                      device="cuda")
    want = ref.murmur_hash_grid_ref(fields, init)[:, 0]
    check(torch.equal(got, want), "bulk_hash != plain version")
    b_ms, b_by = bound(fields.numel() * 8 + 8 + GRID_FLOWS * 8,
                       GRID_FLOWS * (N_FIELDS * FOLD_OPS + FMIX_OPS))
    records.append({
        "name": "bulk_hash", "route": "cuda",
        "source": "src/repro_torch/kernels/flowhash/csrc/flowhash.cu",
        "replaces": "src/repro/kernels/flowhash/kernel.py:70",
        "shape": [GRID_FLOWS, N_FIELDS],
        "max_abs_err": int((got - want).abs().max()),
        "ms": cuda_ms(lambda: ops.bulk_hash(fields, 12345), 50),
        "plain_ms": cuda_ms(
            lambda: ref.murmur_hash_grid_ref(fields, init), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # the values the JAX package pins for its Pallas kernel
    rng42 = np.random.default_rng(42)
    pinned = torch.from_numpy(
        rng42.integers(0, 2**31, (4096, 5)).astype(np.int64)).cuda()
    h = ops.bulk_hash(pinned, 12345).cpu().numpy()
    check(h[:4].tolist() == PINNED_HEAD and int(h.sum()) == PINNED_SUM,
          f"pinned flow-hash values drifted: {h[:4].tolist()} {h.sum()}")
    emit({"phase": "kernels", "pinned_values": "ok",
          "checked": [r["name"] for r in records] + ["bulk_hash_seeded"]})
    return records


def phase_anchor(np):
    """Paper testbed, 256 flows x 1,024 seeds, against the JAX
    package's numpy-engine values."""
    from repro_torch.core import (
        bipartite_pairs, build_paper_testbed, compile_fabric,
        monte_carlo_fim, monte_carlo_throughput, server_name,
    )
    comp = compile_fabric(build_paper_testbed())
    wl = bipartite_pairs([server_name(i) for i in range(8)],
                         [server_name(8 + i) for i in range(8)],
                         flows_per_pair=16)
    seeds = np.arange(1024)
    out = {}
    for backend, (fim_want, rate_want) in ANCHORS.items():
        fim = float(monte_carlo_fim(comp, wl, seeds, hash_backend=backend)
                    .aggregate.mean())
        rate = float(monte_carlo_throughput(comp, wl, seeds,
                                            hash_backend=backend)
                     .rates.mean())
        for name, got, want in (("fim", fim, fim_want),
                                ("rate", rate, rate_want)):
            rel = abs(got - want) / abs(want)
            check(rel <= ANCHOR_RTOL,
                  f"{backend} {name} {got!r} != {want!r} (rel {rel:.3g})")
        out[backend] = {"fim_mean": fim, "rate_mean": rate}
    emit({"phase": "anchor", "fabric": "paper-testbed", "flows": 256,
          "seeds": 1024, "rtol": ANCHOR_RTOL, **out})


def phase_full_scale(np, torch):
    """The main path at full scale; returns the launch counts of the run."""
    from repro_torch.core import (
        bipartite_pairs, build_multipod_fabric, compile_fabric,
        flow_fields_matrix, max_min_rates, monte_carlo_fim,
        monte_carlo_throughput, nic_ip, simulate_paths, synthesize_flows,
    )
    from repro_torch.kernels.flowhash import ops

    t0 = time.perf_counter()
    fab = build_multipod_fabric()
    comp = compile_fabric(fab)
    pod0 = [f"host-{i}" for i in range(64)]
    pod1 = [f"host-{64 + i}" for i in range(64)]
    flows = synthesize_flows(bipartite_pairs(pod0, pod1, FLOWS_PER_PAIR),
                             nic_ip=nic_ip, nics_per_server=1)
    fm = flow_fields_matrix(flows, "5tuple")
    setup_s = time.perf_counter() - t0
    check(len(flows) == GRID_FLOWS, f"{len(flows)} flows")
    hops = simulate_paths(comp, flows, np.arange(4),
                          field_matrix=fm).link_ids.shape[0]

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, torch.cuda.max_memory_allocated()

    ops.reset_launches()
    fim, fim_s, fim_peak = timed(lambda: monte_carlo_fim(
        comp, flows, np.arange(FIM_SEEDS), field_matrix=fm))
    grid_after_fim = ops.LAUNCHES["murmur_hash_grid"]
    tp, tp_s, tp_peak = timed(lambda: monte_carlo_throughput(
        comp, flows, np.arange(TP_SEEDS), field_matrix=fm))
    fields = torch.from_numpy(fm.view(np.int64)).cuda()
    stages, pp_s, _ = timed(lambda: ops.simulate_paper_paths(fields))
    launches = dict(ops.LAUNCHES)

    fim_chunks = -(-FIM_SEEDS // fim.seed_chunk)
    tp_chunks = -(-TP_SEEDS // tp.seed_chunk)
    check(tuple(fim.aggregate.shape) == (FIM_SEEDS,), "FIM shape")
    check(bool(torch.isfinite(fim.aggregate).all())
          and bool((fim.aggregate >= 0).all()), "FIM not finite")
    check(grid_after_fim >= hops * fim_chunks,
          f"{grid_after_fim} grid launches < {hops} hops x {fim_chunks}")
    check(launches["murmur_hash_grid"] - grid_after_fim >= hops * tp_chunks,
          "throughput sweep skipped the hash kernel")
    check(tuple(tp.rates.shape) == (GRID_FLOWS, TP_SEEDS), "rates shape")
    check(bool(torch.isfinite(tp.rates).all())
          and bool((tp.rates > 0).all()), "rates not finite and positive")
    pair_sum = tp.per_pair.sum(0)
    check(bool(torch.allclose(pair_sum, tp.rates.sum(0), rtol=1e-9, atol=0)),
          "per-pair totals do not add up to the flow rates")
    check(launches["bulk_hash"] == 4, "simulate_paper_paths is 4 launches")
    uplinks = torch.bincount(stages["uplink"].long(), minlength=16)
    check(int(uplinks.sum()) == GRID_FLOWS, "stage choices lost flows")
    # the card's sweeps agree with the CPU path (plain versions) on their
    # first two seeds, at full width
    cpu = dict(field_matrix=fm, hash_backend="murmur", device="cpu")
    cpu_fim = monte_carlo_fim(comp, flows, np.arange(2), **cpu)
    check(np.allclose(fim.aggregate[:2].cpu().numpy(),
                      cpu_fim.aggregate.numpy(), rtol=1e-12, atol=0),
          "FIM on the card != FIM on the CPU")
    cpu_tp = monte_carlo_throughput(comp, flows, np.arange(2), **cpu)
    check(np.allclose(tp.rates[:, :2].cpu().numpy(), cpu_tp.rates.numpy(),
                      rtol=1e-9, atol=0), "rates on the card != on the CPU")

    # where the time goes, outside the counted run: one throughput
    # chunk's walk, its link counts and its fill, each timed alone
    res, walk_s, walk_peak = timed(lambda: simulate_paths(
        comp, flows, np.arange(tp.seed_chunk), field_matrix=fm))
    _, counts_s, _ = timed(res.link_flow_counts)
    _, fill_s, fill_peak = timed(lambda: max_min_rates(res))
    del res

    fsum = fim.summary()["aggregate"]
    tsum = tp.summary()
    emit({"phase": "full_scale", "fabric": "multipod default",
          "devices": comp.num_devices, "links": comp.num_links,
          "flows": len(flows), "hops": int(hops), "setup_s": setup_s,
          "seed_cut": None,
          "monte_carlo_fim": {
              "seeds": FIM_SEEDS, "hash_backend": "murmur",
              "seed_chunk": fim.seed_chunk, "chunks": fim_chunks,
              "wall_s": fim_s, "peak_bytes": fim_peak,
              "launches": grid_after_fim, "aggregate": fsum},
          "monte_carlo_throughput": {
              "seeds": TP_SEEDS, "hash_backend": "murmur",
              "seed_chunk": tp.seed_chunk, "chunks": tp_chunks,
              "wall_s": tp_s, "peak_bytes": tp_peak,
              "launches": launches["murmur_hash_grid"] - grid_after_fim,
              "flow_rate": tsum["flow_rate"],
              "pair_total": tsum["pair_total"]},
          "simulate_paper_paths": {"wall_s": pp_s,
                                   "launches": launches["bulk_hash"]},
          "throughput_chunk_stages": {
              "seeds": tp.seed_chunk, "walk_s": walk_s,
              "link_counts_s": counts_s, "fill_s": fill_s,
              "fill_rounds": tp.fill_rounds, "walk_peak_bytes": walk_peak,
              "fill_peak_bytes": fill_peak},
          })
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    t0 = time.perf_counter()
    card = phase_build()
    records = phase_kernels(np, torch)
    phase_anchor(np)
    launches = phase_full_scale(np, torch)
    for r in records:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"main path never launched {r['name']}")
    emit({"kernels": records})
    emit({"phase": "done", "card": card,
          "seconds": time.perf_counter() - t0})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
