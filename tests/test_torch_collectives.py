"""The port's collective source (``repro_torch/launch/collectives.py``)
against the reference's compiled HLO: reduced granite's ``train`` cell on
a (2, 2, 2) ('pod', 'data', 'model') mesh.  The reference compiles it on
8 of its host devices in a subprocess and parses the HLO; the port traces
rank 0 on a fake process group of 8.  The rank groups of the collectives
over 'model' and over the batch axes must be the same sets, and the
port's folded ops times their multipliers must equal an unfolded trace of
the whole step.  The two sides' DCN bytes a step are printed, not held
equal: XLA's combiner is not the program's semantics."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core.hlo_flows import collectives_to_flows  # noqa: E402
from repro_torch.launch.collectives import (  # noqa: E402
    MeshGroups, cell_collectives, read_graph, trace, unfolded,
    unfolded_program,
)
from repro_torch.launch.dryrun import start_fake_group  # noqa: E402
from repro_torch.launch.mesh import device_coords  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = ShapeConfig("train_small", 64, 8, "train")
#: both sides' hosts hold 4 devices (the reference's TPU v5e host), so
#: that one (2, 2, 2) pod is one host and only pod-crossing edges are DCN
CHIPS_PER_HOST = 4

_REF_HLO = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ShapeConfig, get_arch
from repro.core.hlo_flows import collectives_to_flows, extract_collectives
from repro.launch.mesh import device_coords
from repro.launch.specs import build_cell
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
cell = build_cell(get_arch("granite-3-2b").reduced(),
                  ShapeConfig("train_small", 64, 8, "train"), mesh)
with jax.set_mesh(mesh):
    hlo = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                  out_shardings=cell.out_shardings,
                  donate_argnums=cell.donate_argnums
                  ).lower(*cell.args).compile().as_text()
ops = extract_collectives(hlo)
_, stats = collectives_to_flows(ops, device_coords(mesh))
print(json.dumps({"ops": [[o.kind, o.groups, o.multiplier] for o in ops],
                  "dcn_bytes": stats.dcn_bytes, "meta": cell.meta}))
"""


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REF_HLO], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return json.loads(out.splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    """The port's cell on a fake world of 8: (cell, folded ops, the
    unfolded trace of the whole step)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    start_fake_group(8)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        cell = build_cell(get_arch("granite-3-2b").reduced(), SMALL, mesh)
        ops, info = cell_collectives(cell)
        gm = trace(unfolded_program(cell.model, cell.train, cell.mesh,
                                    cell.specs), cell.args)
        whole = read_graph(gm, MeshGroups(cell.mesh))
        coords = device_coords(mesh, chips_per_host=CHIPS_PER_HOST)
        # a second cell over equal meshes, as the dry run's loop builds them
        again, _ = cell_collectives(build_cell(
            get_arch("granite-3-2b").reduced(), SMALL,
            init_device_mesh("cpu", (2, 2, 2),
                             mesh_dim_names=("pod", "data", "model"))))
        yield cell, ops, whole, coords, info, again
    finally:
        dist.destroy_process_group()


def _group_sets(ops, size):
    """The distinct rank-group sets of the ops whose groups hold
    ``size`` ranks each."""
    return {frozenset(frozenset(g) for g in groups)
            for groups in ops if groups and len(groups[0]) == size}


def test_rank_groups_match_the_reference_hlo(reference, port):
    """'model' groups {0,1},{2,3},{4,5},{6,7} and the batch group over
    ('pod', 'data') as one, {0,2,4,6},{1,3,5,7}: the sets XLA's replica
    groups name, on both sides."""
    cell, ops, _, _, _, _ = port
    want = [tuple(map(tuple, groups)) for kind, groups, _ in reference["ops"]
            if kind in ("all-reduce", "all-gather", "reduce-scatter")]
    got = [op.groups for op in ops]
    for size in (2, 4):
        assert _group_sets(got, size) == _group_sets(want, size), size
    model = frozenset(map(frozenset, ((0, 1), (2, 3), (4, 5), (6, 7))))
    batch = frozenset(map(frozenset, ((0, 2, 4, 6), (1, 3, 5, 7))))
    assert _group_sets(got, 2) == {model} and _group_sets(got, 4) == {batch}
    # the rest: the global norm's one scalar all-reduce over the world
    rest = [op for op in ops if len(op.groups[0]) not in (2, 4)]
    assert [(op.kind, op.groups, op.result_bytes, op.multiplier)
            for op in rest] == [("all-reduce", (tuple(range(8)),), 4, 1)]
    assert cell.meta == reference["meta"]


def test_folded_ops_add_up_to_the_unfolded_step(port):
    """Folding by layer class and leaf, times grad_accum (2 here), loses
    and adds no collective: the same count, the same bytes by kind, and
    each folded op a channel of its own."""
    cell, ops, whole, _, info, _ = port
    assert cell.train.grad_accum == 2
    assert sum(op.multiplier for op in ops) == len(whole)
    assert len(ops) < len(whole) // 2
    by_kind = {}
    for op in ops:
        by_kind[op.kind] = by_kind.get(op.kind, 0) + \
            op.result_bytes * op.multiplier
    want = {}
    for op in unfolded(whole):
        want[op.kind] = want.get(op.kind, 0) + op.result_bytes
    assert by_kind == want
    assert sorted(op.channel_id for op in ops) == list(range(1, len(ops) + 1))
    assert info["traced_collectives"] < len(whole)


def test_no_all_gather_without_fsdp(port):
    """The specs imply no all-gather for this cell: reduced granite's
    kv heads divide the model axis, no FSDP, and ZeRO-2 shards no leaf
    this small (under 2^20 elements)."""
    _, ops, whole, _, _, _ = port
    assert not [t for t in whole if t.kind == "all-gather"]
    assert {op.kind for op in ops} == {"all-reduce"}


def test_dcn_bytes_a_step_both_sides(reference, port, capsys):
    """Recorded, not compared: XLA combines and reorders collectives
    (and reshards the input batch by all-to-all); the port's are the
    program's own, per leaf and layer."""
    _, ops, _, coords, _, _ = port
    _, stats = collectives_to_flows(ops, coords)
    ratio = stats.dcn_bytes / reference["dcn_bytes"]
    with capsys.disabled():
        print(f"\nDCN bytes a step, reduced granite train (2, 2, 2): port "
              f"{stats.dcn_bytes}, reference {reference['dcn_bytes']}, "
              f"ratio {ratio:.4f}")
    assert stats.dcn_bytes > 0 and reference["dcn_bytes"] > 0


def test_a_second_cell_over_equal_meshes_reads_the_same_groups(port):
    """DTensor's sharding cache keeps the first of equal meshes, so a
    second cell's trace names the first mesh's groups; the groups are
    told by their ranks, so its ops are the first cell's."""
    _, ops, _, _, _, again = port
    assert [(o.kind, o.groups, o.result_bytes, o.multiplier) for o in again] \
        == [(o.kind, o.groups, o.result_bytes, o.multiplier) for o in ops]
