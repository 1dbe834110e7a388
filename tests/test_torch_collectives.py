"""The port's collective source (``repro_torch/launch/collectives.py``)
against the reference's compiled HLO: reduced granite's ``train`` cell on
a (2, 2, 2) ('pod', 'data', 'model') mesh.  The reference compiles it on
8 of its host devices in a subprocess and parses the HLO; the port traces
rank 0 on a fake process group of 8.  The rank groups of the collectives
over 'model' and over the batch axes must be the same sets, and the
port's folded ops times their multipliers must equal an unfolded trace of
the whole step.  The two sides' DCN bytes a step are printed, not held
equal: XLA's combiner is not the program's semantics.

Four more cells on the same mesh hold the rank groups of every size:
granite widened to vocab 32,768 (its embedding of 2^22 elements reaches
ZeRO-2's and FSDP's leaf sizes) under ZeRO-2 and under FSDP forced for
every model size, whose gathers and reduce-scatters run over the 'data'
pairs within a pod and whose gradients add across the pods over the
'pod' pairs; and reduced qwen2-moe's expert-parallel ``train`` and
``prefill``, whose all-to-alls run over the 'model' pairs."""

import dataclasses
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
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = ShapeConfig("train_small", 64, 8, "train")
PAIRS = {"model": ((0, 1), (2, 3), (4, 5), (6, 7)),
         "data": ((0, 2), (1, 3), (4, 6), (5, 7)),
         "pod": ((0, 4), (1, 5), (2, 6), (3, 7))}
MODEL = frozenset(map(frozenset, PAIRS["model"]))
BATCH = frozenset(map(frozenset, ((0, 2, 4, 6), (1, 3, 5, 7))))
#: (arch, kind, layout): granite widened under ZeRO-2 and forced FSDP,
#: and the MoE's expert-parallel cells
POD_CELLS = [("granite-3-2b", "train", "zero2"),
             ("granite-3-2b", "train", "fsdp"),
             ("qwen2-moe-a2.7b", "train", "ep"),
             ("qwen2-moe-a2.7b", "prefill", "ep")]
#: granite's vocab at which its embedding holds 2^22 elements
WIDE_VOCAB = 32_768
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
        if dist.is_initialized():       # a later fixture may have ended it
            dist.destroy_process_group()


def _group_sets(ops):
    """{group size: the distinct rank-group sets of the ops whose groups
    hold that many ranks each}, for every size."""
    out: dict = {}
    for groups in ops:
        if groups:
            out.setdefault(len(groups[0]), set()).add(
                frozenset(frozenset(g) for g in groups))
    return out


def test_rank_groups_match_the_reference_hlo(reference, port):
    """'model' groups {0,1},{2,3},{4,5},{6,7} and the batch group over
    ('pod', 'data') as one, {0,2,4,6},{1,3,5,7}: the sets XLA's replica
    groups name, on both sides."""
    cell, ops, _, _, _, _ = port
    want = [tuple(map(tuple, groups)) for kind, groups, _ in reference["ops"]
            if kind in ("all-reduce", "all-gather", "reduce-scatter")]
    # the rest: the global norm's one scalar all-reduce over the world
    rest = [op for op in ops if len(op.groups[0]) not in (2, 4)]
    assert [(op.kind, op.groups, op.result_bytes, op.multiplier)
            for op in rest] == [("all-reduce", (tuple(range(8)),), 4, 1)]
    got = _group_sets([op.groups for op in ops if op not in rest])
    assert got == _group_sets(want)
    assert got == {2: {MODEL}, 4: {BATCH}}
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


_REF_POD_HLO = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ShapeConfig, get_arch
from repro.core.hlo_flows import collectives_to_flows, extract_collectives
from repro.launch.mesh import device_coords
from repro.launch.specs import build_cell
arch, kind, layout, vocab = sys.argv[1:5]
cfg = get_arch(arch).reduced()
if arch == "granite-3-2b":
    cfg = dataclasses.replace(cfg, vocab=int(vocab))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
kw = {"fsdp_threshold_params": 0} if layout == "fsdp" else {}
cell = build_cell(cfg, ShapeConfig(kind + "_small", 64, 8, kind), mesh, **kw)
with jax.set_mesh(mesh):
    hlo = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                  out_shardings=cell.out_shardings,
                  donate_argnums=cell.donate_argnums
                  ).lower(*cell.args).compile().as_text()
ops = extract_collectives(hlo)
_, stats = collectives_to_flows(ops, device_coords(mesh))
print(json.dumps({"ops": [[o.kind, o.groups, o.multiplier, o.result_bytes]
                          for o in ops],
                  "dcn_bytes": stats.dcn_bytes, "meta": cell.meta}))
"""


def _pod_cfg(arch):
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, vocab=WIDE_VOCAB) \
        if arch == "granite-3-2b" else cfg


@pytest.fixture(scope="module", params=POD_CELLS,
                ids=["-".join(c) for c in POD_CELLS])
def pod_cell(request):
    """(the case, the reference's ops and DCN bytes, the port's cell, its
    folded ops and coordinates) of one cell on (2, 2, 2)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    arch, kind, layout = request.param
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REF_POD_HLO, arch, kind,
                          layout, str(WIDE_VOCAB)], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    ref = json.loads(out.splitlines()[-1])
    start_fake_group(8)
    try:
        with pytest.MonkeyPatch.context() as mp:
            if layout == "fsdp":
                mp.setattr(specs, "FSDP_MIN_PARAMS", 0)
            mesh = init_device_mesh("cpu", (2, 2, 2),
                                    mesh_dim_names=("pod", "data", "model"))
            cell = build_cell(_pod_cfg(arch),
                              ShapeConfig(kind + "_small", 64, 8, kind), mesh)
            ops, _ = cell_collectives(cell)
        yield (arch, kind, layout), ref, cell, ops, \
            device_coords(mesh, chips_per_host=CHIPS_PER_HOST)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dead_aux_gathers(ref_ops, kind, cfg):
    """The reference prefill's all-gathers of the router's f32 (B, S, E)
    probabilities over the batch group: the aux loss of its scanned
    layers, which ``prefill_last`` drops and XLA keeps; the port's
    prefill computes no aux loss."""
    if kind != "prefill" or cfg.moe is None:
        return []
    size = SMALL.global_batch * SMALL.seq_len * cfg.moe.num_experts * 4
    return [o for o in ref_ops if o[0] == "all-gather" and o[3] == size
            and len(o[1][0]) == 4]


def test_pod_cells_rank_groups_match_the_reference_hlo(pod_cell):
    """Every group size, all-reduces, all-gathers and reduce-scatters
    together: the 'model', 'data' and 'pod' pairs and the batch group
    where the reference has them; the port's only other group is the
    global norm's scalar all-reduce over the world.  The all-to-alls run
    over the 'model' pairs, a set of the reference's (whose other
    all-to-alls reshard the input batch, which the port never moves)."""
    (arch, kind, layout), ref, cell, ops, _ = pod_cell
    assert cell.meta == ref["meta"]
    dead = _dead_aux_gathers(ref["ops"], kind, cell.arch)
    assert sum(o[2] for o in dead) == \
        (cell.arch.num_layers if kind == "prefill" else 0)
    reduce = ("all-reduce", "all-gather", "reduce-scatter")
    want = [tuple(map(tuple, o[1])) for o in ref["ops"]
            if o[0] in reduce and o not in dead]
    world = [op for op in ops if len(op.groups[0]) == 8]
    assert [(op.kind, op.result_bytes) for op in world] == \
        ([("all-reduce", 4)] if kind == "train" else [])
    got = [op.groups for op in ops if op.kind in reduce and op not in world]
    assert _group_sets(got) == _group_sets(want)
    a2a = _group_sets([op.groups for op in ops if op.kind == "all-to-all"])
    ref_a2a = _group_sets([tuple(map(tuple, o[1])) for o in ref["ops"]
                           if o[0] == "all-to-all"])
    if layout == "ep":
        assert a2a == {2: {MODEL}}
        assert MODEL in ref_a2a[2]
    else:
        assert not a2a


def test_pod_cells_all_to_all_counts_against_the_reference(pod_cell):
    """The expert weights' all-to-alls a step over the 'model' pairs,
    counted with their multipliers.  The reference's compiled step runs
    3 a layer and microbatch (one a weight) at each of the forward, the
    remat group's recompute, the layer's own recompute and the backward:
    12·L·A; its prefill 3·L.  The port runs the same program but for the
    last layer of each remat group of G, whose part of the group's
    recompute torch's non-reentrant checkpoint skips (it stops once the
    tensors the backward saved are back): 3·A·(4·L − L/G).  Granite's
    cells run none."""
    (arch, kind, layout), ref, cell, ops, _ = pod_cell
    L = cell.arch.num_layers
    port = sum(op.multiplier for op in ops if op.kind == "all-to-all")
    ref_n = sum(o[2] for o in ref["ops"] if o[0] == "all-to-all"
                and frozenset(map(frozenset, o[1])) == MODEL)
    if layout != "ep":
        assert port == ref_n == 0
    elif kind == "prefill":
        assert port == ref_n == 3 * L
    else:
        A, G = cell.train.grad_accum, cell.model.remat.group_for(L)
        assert (A, G) == (2, 2)
        assert ref_n == 3 * A * 4 * L
        assert port == 3 * A * (4 * L - L // G)


def test_fsdp_and_zero2_shard_within_a_pod(pod_cell):
    """Granite's embedding is gathered and reduce-scattered over the
    'data' pairs only, never over a group that spans both pods, and its
    gradient adds across the pods by an all-reduce over the 'pod'
    pairs; the MoE's cells shard no leaf over 'data'."""
    (arch, kind, layout), _, _, ops, coords = pod_cell
    sets = {op.kind: set() for op in ops}
    for op in ops:
        sets[op.kind].add(frozenset(map(frozenset, op.groups)))
    data = frozenset(map(frozenset, PAIRS["data"]))
    pod = frozenset(map(frozenset, PAIRS["pod"]))
    for op in ops:
        if op.kind in ("all-gather", "reduce-scatter"):
            for g in op.groups:
                assert len({coords[r][0] for r in g}) == 1, op
    if layout in ("zero2", "fsdp"):
        assert sets["all-gather"] == {data}
        assert sets["reduce-scatter"] == {data}
        assert pod in sets["all-reduce"]
    else:
        assert "all-gather" not in sets and "reduce-scatter" not in sets
        assert pod not in sets["all-reduce"]


def test_pod_cells_dcn_bytes_both_sides(pod_cell, capsys):
    """Recorded, not compared (see ``test_dcn_bytes_a_step_both_sides``)."""
    case, ref, _, ops, coords = pod_cell
    _, stats = collectives_to_flows(ops, coords)
    with capsys.disabled():
        print(f"\nDCN bytes a step, {' '.join(case)} (2, 2, 2): port "
              f"{stats.dcn_bytes}, reference {ref['dcn_bytes']}")
    assert (stats.dcn_bytes > 0) == (case[1] == "train")


def test_gradients_reduce_scatter_before_the_pod_all_reduce():
    """A gradient partial over 'pod' and 'data' reaches a leaf sharded
    over 'data' and replicated over 'pod' by a reduce-scatter over the
    'data' pairs and then an all-reduce over the 'pod' pairs of this
    rank's shard alone (``parallel.sharding.reduce_to``), as XLA orders
    them, whatever order DTensor's own planner would take."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import step_mesh
    from repro_torch.parallel.sharding import reduce_to

    start_fake_group(8)
    try:
        root = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        flat = step_mesh(root)

        def fn(local):
            g = DTensor.from_local(local, root,
                                   (Partial(), Partial(), Replicate()),
                                   run_check=False)
            return reduce_to(g, (Replicate(), Shard(1), Replicate())
                             ).to_local()

        with FakeTensorMode():
            grad = torch.zeros(64, 32)
        ops = read_graph(trace(fn, (grad,)), MeshGroups(flat))
        shard = 64 * 16 * 4
        assert [(o.kind, frozenset(map(frozenset, o.groups)), o.result_bytes)
                for o in ops] == [
            ("reduce-scatter", frozenset(map(frozenset, PAIRS["data"])), shard),
            ("all-reduce", frozenset(map(frozenset, PAIRS["pod"])), shard)]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
