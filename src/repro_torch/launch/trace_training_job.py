"""FlowTracer applied to the port's own training job: the counterpart of
``examples/trace_training_job.py``, through the port's ``core``.

    PYTHONPATH=src python -m repro_torch.launch.trace_training_job --arch granite-3-2b
    PYTHONPATH=src python -m repro_torch.launch.trace_training_job --record R.json

1. runs the arch's train cell on the two-pod 512-GPU mesh through the dry
   run, in a child process (``launch/dryrun.py``: a fake process group,
   no device memory touched), or reads a record it wrote (``--record``);
2. takes the cell's collectives (``launch/collectives.py``, folded with
   their multipliers) and decomposes the pod-crossing ring edges into
   RoCE flows between host NICs (``core.collectives_to_flows``), hosts of
   8 GPUs (``launch.mesh.CHIPS_PER_HOST``), 32 a pod;
3. traces those flows across the DCN leaf-spine fabric under ECMP and
   under automated static routing and reports FIM, what an operator
   would do before launching a 512-GPU job.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ..core import (
    EcmpRouting, FlowTracer, PairSpec, WorkloadDescription, analyze_paths,
    build_multipod_fabric, collectives_to_flows, fim, static_route_assignment,
    summarize,
)
from ..core.hlo_flows import CollectiveOp
from .mesh import CHIPS_PER_HOST, coords_of

LAYERS = ["leaf-to-spine", "spine-to-leaf"]


def dryrun_record(arch: str, shape: str, out: str, *, reduced: bool = False
                  ) -> dict:
    """The two-pod record of the cell, made by the dry run in a child
    process (it starts a fake process group of 512 ranks)."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", "multi", "--out", out, "--force"]
    subprocess.run(cmd + (["--reduced"] if reduced else []), env=env,
                   check=True)
    with open(os.path.join(out, "multi", f"{arch}__{shape}.json")) as f:
        return json.load(f)


def ops_of(record: dict) -> list[CollectiveOp]:
    return [CollectiveOp(**{**op, "groups": tuple(tuple(g) for g in op["groups"]),
                            "pairs": tuple(tuple(p) for p in op["pairs"])})
            for op in record["ops"]]


def trace_job(record: dict) -> dict:
    """The cell's DCN flows and their FIM under ECMP and static routing."""
    ops = ops_of(record)
    mesh = record["mesh"]
    n = record["n_chips"]
    npods = mesh.get("pod", 1)
    coords = coords_of(list(range(n)), npods, CHIPS_PER_HOST)
    summ = summarize(ops)
    flows, stats = collectives_to_flows(ops, coords)
    out = {"arch": record["arch"], "shape": record["shape"], "mesh": mesh,
           "collectives": summ.per_kind_count,
           "wire_bytes_per_device": summ.total_wire_bytes,
           "ring_edges": {"intra_host": stats.intra_host,
                          "ici": stats.intra_pod_ici,
                          "dcn": stats.inter_pod_dcn},
           "dcn_bytes": stats.dcn_bytes, "dcn_flows": len(flows)}
    if not flows:
        return out
    fabric = build_multipod_fabric(num_pods=npods,
                                   hosts_per_pod=n // npods // CHIPS_PER_HOST)
    pairs = sorted({(f.src, f.dst) for f in flows})
    wl = WorkloadDescription(pairs=[PairSpec(s, d, 0) for s, d in pairs])
    res = FlowTracer(fabric, EcmpRouting(fabric, seed=1), wl, flows).trace()
    _, static_paths = static_route_assignment(fabric, flows)
    out.update(
        host_pairs=len(pairs),
        ecmp_report=analyze_paths(res.paths, fabric, layers=LAYERS).summary(),
        static_report=analyze_paths(static_paths, fabric,
                                    layers=LAYERS).summary(),
        fim_ecmp=fim(res.paths, fabric, layers=LAYERS),
        fim_static=fim(static_paths, fabric, layers=LAYERS))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--record", default=None,
                    help="a two-pod record the dry run wrote")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    if args.record:
        with open(args.record) as f:
            record = json.load(f)
    else:
        record = dryrun_record(args.arch, args.shape, args.out,
                               reduced=args.reduced)
    res = trace_job(record)
    print(f"collectives: {res['collectives']}")
    print(f"wire bytes/device/step: {res['wire_bytes_per_device'] / 2**20:.0f} MiB")
    e = res["ring_edges"]
    print(f"ring edges: intra-host={e['intra_host']} ICI={e['ici']} "
          f"DCN={e['dcn']}")
    print(f"DCN traffic: {res['dcn_bytes'] / 2**20:.0f} MiB/step across "
          f"{res['dcn_flows']} flows")
    if not res["dcn_flows"]:
        print("no pod-crossing flows (nothing for the DCN analysis)")
        return res
    print("\n== DCN path analysis (ECMP) ==")
    print(res["ecmp_report"])
    print("\n== after FlowTracer-driven static repath ==")
    print(res["static_report"])
    print(f"\nFIM: ECMP {res['fim_ecmp']:.1f}% -> "
          f"static {res['fim_static']:.1f}%")
    return res


if __name__ == "__main__":
    main()
