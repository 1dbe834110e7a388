"""Time this checkout's full-scale strategy routes against another
checkout's on one card, in alternating processes.

    git archive <rev> | tar -x -C _checkout/parent
    PYTHONPATH=src python3 -m repro_torch.core.compare_routes _checkout/parent

(``_checkout/`` is gitignored.)  Both checkouts hold a package named
``repro_torch``, so each round starts one process per checkout, in
alternating order (this, other, other, this, ...).  A process routes
``chip_smoke.py``'s full-scale sweeps from its own checkout
(64 seeds: ``prime-spray`` and the wave on the even mix,
``adaptive-spray`` on the 3:1 skewed mix, ``congestion-aware``), each
once to warm up and then ``REPS`` times, host clock ending in a
synchronise; ``adaptive-spray`` also under byte demand (the skewed
flows at alternating 2**20 and 2**30 bytes, as ``chip_smoke.py`` routes
it).  Prints the card and, per checkout and strategy, the median route
seconds and every process's medians.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ROUNDS, REPS = 3, 3

_CHILD = r'''
import dataclasses, json, sys, time
import numpy as np, torch
sys.path[:0] = ["src", "."]
import chip_smoke as cs
import repro_torch.core as T
big = T.compile_fabric(T.build_multipod_fabric())
even = T.synthesize_flows(T.bipartite_pairs(
    [f"host-{i}" for i in range(64)], [f"host-{64 + i}" for i in range(64)],
    cs.FLOWS_PER_PAIR), nic_ip=T.nic_ip, nics_per_server=1)
skew = cs.skewed_flows(T)
skew_bytes = [dataclasses.replace(f, bytes=2**20 if j % 2 == 0 else 2**30)
              for j, f in enumerate(skew)]
fm_even = T.flow_fields_matrix(even, "5tuple")
fm_skew = T.flow_fields_matrix(skew, "5tuple")
out = {}
for key, name, fl, fm, demand in (
        ("prime-spray", "prime-spray", even, fm_even, "uniform"),
        ("adaptive-spray", "adaptive-spray", skew, fm_skew, "uniform"),
        ("adaptive-spray (bytes)", "adaptive-spray", skew_bytes, fm_skew,
         "bytes"),
        ("congestion-aware", "congestion-aware", even, fm_even, "uniform"),
        ("wave-congestion-aware", "wave-congestion-aware", even, fm_even,
         "uniform")):
    times = []
    for _ in range(1 + REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        T.simulate_paths(big, fl, np.arange(cs.SPRAY_SEEDS), strategy=name,
                         field_matrix=fm, hash_backend="murmur",
                         demand_mode=demand)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    out[key] = sorted(times[1:])[REPS // 2]
print(json.dumps(out))
'''


def _route_times(checkout: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", f"REPS = {REPS}\n{_CHILD}"], cwd=checkout,
        env={**os.environ, "PYTHONPATH": str(checkout / "src")},
        capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(other: str) -> None:
    sides = {"this": ROOT, "other": Path(other).resolve()}
    runs = {name: [] for name in sides}
    for r in range(ROUNDS):
        for name in (list(sides) if r % 2 == 0 else list(sides)[::-1]):
            runs[name].append(_route_times(sides[name]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    median = {name: {s: sorted(r[s] for r in rs)[len(rs) // 2]
                     for s in rs[0]} for name, rs in runs.items()}
    print(json.dumps({"card": smi, "other": str(sides["other"]),
                      "median_route_s": median, "runs": runs}))


if __name__ == "__main__":
    main(sys.argv[1])
