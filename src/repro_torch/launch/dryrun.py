"""Multi-pod dry run of the port: build every in-scope (arch x shape) cell
on the production meshes, hold its memory against the card's, and read
its roofline terms and collective traffic for FlowTracer.  The port of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all      # 10 cells x 2 meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

It runs in a process of its own: ``main`` starts a fake process group of
the mesh's world size (256 or 512 ranks; no memory, no network) and
traces rank 0's program (``launch/collectives.py``).  Nothing here needs
or touches a card.  Per cell it writes
``results/dryrun_torch/<mesh>/<arch>__<shape>.json`` with the reference's
fields.  The port has no compiled program, so XLA's ``memory_analysis``
and ``cost_analysis`` fields are null (``null_fields`` says so); the
memory verdict is the analytic residency against the card's 80 GB.
Cells outside the ``train`` and ``prefill`` cells of the dense family and
of the MoE without MLA raise, naming their family or shape
(``specs.check_cell``); ``--all`` lists them as refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..configs import ARCHS, applicable_shapes, get_arch, get_shape
from ..core.hlo_flows import collectives_to_flows, summarize
from ..core.placement import ring_edge_stats
from .flops import cell_cost, resident_bytes
from .mesh import (
    DEVICE_MEMORY, HBM_BW, ICI_LINK_BW, PEAK_FLOPS_BF16, device_coords,
    make_production_mesh, mesh_shape,
)
from .specs import build_cell, check_cell

#: the reference's fields the port cannot fill: it compiles nothing
NULL_FIELDS = {
    "memory": ["argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_bytes"],
    "cost": ["flops_hlo_raw", "bytes_accessed_hlo_raw"],
    "why": "no compiled program: XLA's memory_analysis and cost_analysis "
           "have no counterpart in a traced torch program",
}


def roofline(arch, shape, meta: dict, *, n_chips: int, model_shards: int,
             wire_bytes: float, peak_flops: float = PEAK_FLOPS_BF16,
             hbm_bw: float = HBM_BW, link_bw: float = ICI_LINK_BW
             ) -> tuple:
    """The three roofline terms of a cell (the reference's arithmetic,
    ``repro/launch/dryrun.py``, given the device's constants: the H100's
    by default).  Returns (the analytic ``CellCost``, the terms)."""
    ac = cell_cost(
        arch, shape,
        n_params=meta["params"], n_chips=n_chips,
        model_shards=model_shards,
        data_shards=n_chips // model_shards,
        grad_accum=meta.get("grad_accum", 1),
        fsdp=meta.get("fsdp", False),
        opt_bytes_per_param=4 if meta.get("opt_state_dtype") == "bfloat16" else 8,
    )
    flops_dev = ac.total_flops / n_chips
    terms = {"compute_s": flops_dev / peak_flops,
             "memory_s": ac.hbm_bytes / hbm_bw,
             "collective_s": wire_bytes / link_bw}
    dominant = max(terms, key=terms.get)
    # MODEL_FLOPS = 6*N*D train / 2*N*D fwd-only, D = tokens this step
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops_dev = mult * meta["active_params"] * tokens / n_chips
    return ac, {**terms, "dominant": dominant,
                "model_flops_per_dev": model_flops_dev,
                "useful_flop_ratio": model_flops_dev / flops_dev if flops_dev else 0.0,
                "bound_s": max(terms.values())}


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, out_dir: str,
             *, force: bool = False, verbose: bool = True,
             reduced: bool = False) -> dict:
    """One cell on its production mesh (the fake process group of its
    world size must be started), its record written to ``out_dir``;
    ``reduced``: the config's smoke-scale variant."""
    from .collectives import cell_collectives

    mesh_tag = "multi" if multi_pod else "single"
    os.makedirs(os.path.join(out_dir, mesh_tag), exist_ok=True)
    out_path = os.path.join(out_dir, mesh_tag, f"{arch_name}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    arch = get_arch(arch_name)
    if reduced:
        arch = arch.reduced()
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.mesh.numel()
    model_shards = mesh_shape(mesh)["model"]

    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh)
    t_build = time.perf_counter() - t0
    ops, trace_info = cell_collectives(cell)
    summ = summarize(ops)
    coords = device_coords(mesh)
    flows, edge_stats = collectives_to_flows(ops, coords)

    edge_classes = {"intra_host": 0, "intra_pod": 0, "inter_pod": 0}
    for op in ops:
        for g in op.groups:
            if len(g) > 1:
                st = ring_edge_stats(list(g), coords)
                for k in edge_classes:
                    edge_classes[k] += st[k]

    wire = summ.total_wire_bytes
    ac, terms = roofline(arch, shape, cell.meta, n_chips=n_chips,
                         model_shards=model_shards, wire_bytes=wire)
    res = resident_bytes(
        arch, shape, n_params=cell.meta["params"], n_chips=n_chips,
        model_shards=model_shards,
        grad_accum=cell.meta.get("grad_accum", 1),
        fsdp=cell.meta.get("fsdp", False),
        opt_bytes_per_param=4 if cell.meta.get("opt_state_dtype") == "bfloat16" else 8,
    )

    record = {
        **cell.meta,
        "mesh_tag": mesh_tag,
        "n_chips": int(n_chips),
        "lower_s": t_build,
        "compile_s": None,
        "trace": trace_info,
        "null_fields": NULL_FIELDS,
        "memory": {
            "argument_bytes": None, "output_bytes": None, "temp_bytes": None,
            "alias_bytes": None, "peak_bytes": None,
            "resident_analytic": res,
            "device_bytes": DEVICE_MEMORY,
            "fits": res["total"] < DEVICE_MEMORY,
        },
        "cost": {
            "flops_analytic_per_dev": ac.total_flops / n_chips,
            "hbm_bytes_analytic_per_dev": ac.hbm_bytes,
            "fwd_flops_global": ac.fwd_flops,
            "attn_flops_global": ac.attn_flops,
            "flops_hlo_raw": None,
            "bytes_accessed_hlo_raw": None,
        },
        "collectives": {
            "count_by_kind": summ.per_kind_count,
            "wire_bytes_by_kind": summ.per_kind_wire,
            "wire_bytes_total": wire,
            "operand_bytes_total": summ.total_operand_bytes,
            "edge_classes": edge_classes,
            "dcn_flows": len(flows),
            "dcn_bytes": edge_stats.dcn_bytes,
            "ici_bytes": edge_stats.ici_bytes,
        },
        "roofline": terms,
        # the folded collectives themselves, for the trace job
        "ops": [dataclasses.asdict(op) for op in ops],
    }
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)

    if verbose:
        fit = "FITS" if record["memory"]["fits"] else "OVER 80 GB"
        dom = terms["dominant"]
        print(f"[{mesh_tag}] {arch_name} x {shape_name}: build {t_build:.1f}s, "
              f"trace {trace_info['trace_s']:.1f}s "
              f"({trace_info['traced_collectives']} collectives -> "
              f"{trace_info['folded_ops']} ops), "
              f"resident {res['total'] / 1e9:.2f} GB ({fit}), "
              f"wire {wire / 2**20:.1f} MiB, dcn {edge_stats.dcn_bytes / 2**20:.1f} "
              f"MiB in {len(flows)} flows, dominant={dom} "
              f"({terms[dom] * 1e3:.2f} ms), useful={terms['useful_flop_ratio']:.2f}",
              flush=True)
    return record


def start_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (replacing one already started)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' smoke-scale variants on the same "
                         "meshes (a quick end-to-end check)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells: list[tuple[str, str]] = []
    refused: list[tuple[str, str, str]] = []
    if args.all:
        for a in ARCHS.values():
            for s in applicable_shapes(a):
                try:
                    check_cell(a, s)
                    cells.append((a.name, s.name))
                except NotImplementedError as e:
                    refused.append((a.name, s.name, str(e)))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        check_cell(get_arch(args.arch), get_shape(args.shape))
        cells.append((args.arch, args.shape))

    failures = []
    for mp in meshes:
        start_fake_group(512 if mp else 256)
        for arch_name, shape_name in cells:
            try:
                run_cell(arch_name, shape_name, mp, args.out, force=args.force,
                         reduced=args.reduced)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures.append((arch_name, shape_name, mp, repr(e)))
                traceback.print_exc()
    for a, s, why in refused:
        print(f"refused {a} x {s}: {why}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} dry-run cells passed"
          + (f"; {len(refused)} cells refused" if refused else ""))


if __name__ == "__main__":
    main()
