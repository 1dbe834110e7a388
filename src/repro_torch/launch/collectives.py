"""The port's collective source: every collective of a cell's sharded step
as ``CollectiveOp`` records, read from the program itself.

The reference compiles the step with XLA, whose SPMD partitioner decides
the collectives, and parses them out of the HLO text
(``core/hlo_flows.py::extract_collectives``).  Torch has no such text.
Here rank 0 of a fake process group of the mesh's world size traces the
cell's function (``launch/specs.py``) over ``FakeTensorMode`` stand-ins
with ``make_fx``: DTensor runs the program as each rank would and its
collectives appear as ``_c10d_functional`` nodes in the graph, with
their fake results' shapes and their groups' names.

The reference's ops carry loop trip counts.  The port's trace unrolls
the Python layer loop, so it folds: marks in the graph (``mark_op``)
bound each layer's forward and backward (``LayerMark``, through
``Model.layer_mark``), each leaf's gradient collectives and the step's
phases.  Layers whose collectives match op for op form a class (sqrt
remat reruns some layers more than others), and the k-th collective of
every layer of a class becomes one op whose multiplier counts them; a
leaf's gradient collective folds across layers the same way, by the
leaf's place in its layer.  The microbatch's ops then count
``grad_accum`` times, since one microbatch is traced.  The folded ops'
count times their multipliers equals an unfolded trace of the whole
step (``unfolded_program``; the tests hold the two together).  Each
folded op has its own ``channel_id``, so ``collectives_to_flows`` makes
one elephant flow of it per ring edge, as the reference does for a
scanned body.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.hlo_flows import CollectiveOp, wire_and_operand
from ..parallel.sharding import map_specs, place, root_mesh
from ..tree import leaves, paths, rebuild

#: mark events: a layer's forward and backward bounds, a gradient leaf,
#: and the step's phases
FWD_ENTER, FWD_EXIT, BWD_ENTER, BWD_EXIT, LEAF, MICRO, UPDATE = range(7)
#: the reference's names of the ``_c10d_functional`` collectives
KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}

_LIB: list = []


def mark_op():
    """``torch.ops.repro_torch_trace.mark(int index, int event)``: a
    no-op that leaves a node in a traced graph (defined at first use)."""
    if not _LIB:
        lib = torch.library.Library("repro_torch_trace", "DEF")
        lib.define("mark(int index, int event) -> ()")
        lib.impl("mark", lambda index, event: None,
                 "CompositeExplicitAutograd")
        _LIB.append(lib)
    return torch.ops.repro_torch_trace.mark


class LayerMark(torch.autograd.Function):
    """Identity on the residual stream whose forward and backward leave
    marks: at a layer's entry FWD_ENTER, and BWD_EXIT when its gradient
    has gone through the layer; at its exit FWD_EXIT, and BWD_ENTER."""

    @staticmethod
    def forward(ctx, x, index: int, fwd: int, bwd: int):
        ctx.index, ctx.bwd = index, bwd
        mark_op()(index, fwd)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mark_op()(ctx.index, ctx.bwd)
        return g, None, None, None


def layer_mark(x: torch.Tensor, i: int, where: str) -> torch.Tensor:
    """``Model.layer_mark`` for the trace."""
    if where == "enter":
        return LayerMark.apply(x, i, FWD_ENTER, BWD_EXIT)
    return LayerMark.apply(x, i, FWD_EXIT, BWD_ENTER)


def _placed(tree, mesh, specs):
    """Local tensors as DTensors on the step mesh ``mesh`` (or its root,
    ``place``) placed by their specs."""
    from torch.distributed.tensor import DTensor

    return map_specs(lambda t, s: DTensor.from_local(
        t, *place(mesh, s), run_check=False), tree, specs)


def _locals(tree):
    return rebuild(tree, [t.to_local() for t in leaves(tree)])


def train_program(model, tc, mesh, specs) -> Callable:
    """The cell's traced function for ``train``: one microbatch's loss and
    gradient into the accumulator (between MICRO and UPDATE marks), then
    the update, each leaf's gradient collectives after a LEAF mark.
    Runs the step's own pieces (``train/step.py``)."""
    from ..train.step import accumulate, grad_accumulator, microbatch_step
    from ..train.step import placed_like, update_step

    marked = dataclasses.replace(model, layer_mark=layer_mark)

    def fn(p_local, opt_local, batch):
        mark = mark_op()
        params = _placed(p_local, mesh, specs)
        opt = {"m": _placed(opt_local["m"], mesh, specs),
               "v": _placed(opt_local["v"], mesh, specs),
               "step": opt_local["step"]}
        mark(-1, MICRO)
        acc = grad_accumulator(params, tc) if tc.grad_accum > 1 else None
        loss, _, grads = microbatch_step(marked, tc, params, batch, 0)
        if acc is not None:
            for n, (a, g) in enumerate(zip(acc, leaves(grads))):
                mark(n, LEAF)
                accumulate([a], [g])
            grads = acc
        mark(-1, UPDATE)
        flat = grads if isinstance(grads, list) else leaves(grads)
        placed = []
        for n, (p, g) in enumerate(zip(leaves(params), flat)):
            mark(n, LEAF)
            placed += leaves(placed_like([p], [g]))
        mark(-1, UPDATE)              # the norm's all-reduce: no leaf's
        params, opt, metrics = update_step(
            tc, params, opt, placed if acc is not None
            else rebuild(params, placed))
        return _locals(params), metrics["grad_norm"], loss

    return fn


def prefill_program(model, mesh, specs) -> Callable:
    """The cell's traced function for ``prefill``: the last position's
    logits (B, V), as the reference's ``prefill_last``."""
    from ..train.step import shard_batch

    marked = dataclasses.replace(model, layer_mark=layer_mark)

    def fn(p_local, batch):
        params = _placed(p_local, mesh, specs)
        logits = marked.prefill(params, shard_batch(batch, mesh),
                                last_only=True)[:, 0, :]
        return logits.to_local()

    return fn


def unfolded_program(model, tc, mesh, specs) -> Callable:
    """The whole train step as the launcher runs it (every microbatch,
    no marks): what the folded ops must add up to."""
    from ..train.optimizer import adamw_init
    from ..train.step import make_train_step

    step = make_train_step(model, tc)

    def fn(p_local, opt_local, batch):
        params = _placed(p_local, mesh, specs)
        opt = adamw_init(params, tc.optimizer)
        params, _, metrics = step(params, opt, batch)
        return _locals(params), metrics["loss"]

    return fn


def trace(fn: Callable, args: tuple) -> torch.fx.GraphModule:
    """``make_fx`` of ``fn`` over fake stand-ins ``args``."""
    from torch.fx.experimental.proxy_tensor import make_fx

    fake = next(t for t in leaves(list(args)) if isinstance(t, torch.Tensor))
    with fake.fake_mode:
        return make_fx(fn)(*args)


class MeshGroups:
    """Process-group name -> every rank group of the mesh dim it spans
    (all of them, not only this rank's, as HLO replica groups list them),
    over the step mesh's dims and its root's, or the whole world.  A
    group is told by its ranks, not its name: DTensor's sharding cache
    keeps the first of equal meshes, so a trace may name the groups of an
    earlier mesh over the same ranks."""

    def __init__(self, mesh):
        import torch.distributed as dist

        world = dist.get_world_size()
        self.by_ranks = {tuple(range(world)): (tuple(range(world)),)}
        for m in (mesh, root_mesh(mesh)):
            for d in range(m.ndim):
                rows = tuple(tuple(int(r) for r in row) for row in
                             m.mesh.movedim(d, -1).reshape(-1, m.size(d))
                             .tolist())
                mine = next(r for r in rows if dist.get_rank() in r)
                self.by_ranks.setdefault(mine, rows)

    def __getitem__(self, name: str) -> tuple:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        ranks = tuple(dist.get_process_group_ranks(_resolve_process_group(name)))
        if ranks not in self.by_ranks:
            raise KeyError(f"group {name} over ranks {ranks} is no dim of "
                           f"the mesh")
        return self.by_ranks[ranks]


def _group_name(node) -> str:
    return next(a for a in reversed(node.args) if isinstance(a, str))


@dataclasses.dataclass(frozen=True)
class Traced:
    """One collective node of a graph, with where the marks put it."""
    kind: str
    result_bytes: int
    groups: tuple
    layer: int | None          # the layer whose forward/backward issued it
    leaf: int | None           # the gradient leaf it belongs to
    micro: bool                # in the microbatch's part (x grad_accum)
    line_no: int

    @property
    def signature(self) -> tuple:
        return self.kind, self.result_bytes, self.groups


def read_graph(gm: torch.fx.GraphModule, groups: MeshGroups) -> list[Traced]:
    """The collectives of ``gm`` in order, each placed by the marks."""
    mark = mark_op()
    out: list[Traced] = []
    stack: list[tuple[int, str]] = []      # open (layer, "fwd" | "bwd")
    leaf, micro = None, False
    for n_no, node in enumerate(gm.graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is mark.default:
            index, event = node.args
            if event in (FWD_ENTER, BWD_ENTER):
                # a layer's forward nests in no forward, a backward in nothing
                while stack and (event == BWD_ENTER or stack[-1][1] == "fwd"):
                    stack.pop()
                stack.append((index, "fwd" if event == FWD_ENTER else "bwd"))
            elif event in (FWD_EXIT, BWD_EXIT):
                which = (index, "fwd" if event == FWD_EXIT else "bwd")
                while stack and stack.pop() != which:
                    pass
            elif event == LEAF:
                leaf = index
            else:
                leaf, micro = None, event == MICRO
            continue
        target = str(node.target)
        if not target.startswith("_c10d_functional.") or "wait_tensor" in target:
            continue
        op = target.split(".")[1]
        if op not in KINDS:
            raise NotImplementedError(f"collective {target} has no kind in "
                                      f"the reference's vocabulary")
        val = node.meta["val"]
        out.append(Traced(
            kind=KINDS[op], result_bytes=val.numel() * val.element_size(),
            groups=groups[_group_name(node)],
            layer=stack[-1][0] if stack else None, leaf=leaf, micro=micro,
            line_no=n_no))
    return out


def fold(traced: list[Traced], leaf_paths: list[str], grad_accum: int
         ) -> list[CollectiveOp]:
    """The folded ``CollectiveOp`` records (see the module's doc), in the
    order of their first collective, channels numbered from 1."""
    by_layer: dict[int, list[Traced]] = {}
    for t in traced:
        if t.layer is not None:
            by_layer.setdefault(t.layer, []).append(t)
    layer_class = {i: tuple(t.signature for t in ts)
                   for i, ts in by_layer.items()}
    keys, seen_in_layer, seen_in_leaf = [], {}, {}
    for t in traced:
        if t.layer is not None:
            k = seen_in_layer.get(t.layer, 0)
            seen_in_layer[t.layer] = k + 1
            keys.append(("layer", layer_class[t.layer], k, t.micro))
        elif t.leaf is not None:
            k = seen_in_leaf.get((t.leaf, t.micro), 0)
            seen_in_leaf[(t.leaf, t.micro)] = k + 1
            # a layer leaf's path without its layer index
            where = "/".join(p for p in leaf_paths[t.leaf].split("/")
                             if not p.isdigit())
            keys.append(("leaf", where, t.signature, k, t.micro))
        else:
            keys.append(("step", t.line_no))
    firsts: dict[tuple, Traced] = {}
    counts: dict[tuple, int] = {}
    for key, t in zip(keys, traced):
        firsts.setdefault(key, t)
        counts[key] = counts.get(key, 0) + 1
    ops = []
    for channel, (key, t) in enumerate(firsts.items(), 1):
        n = max(len(g) for g in t.groups)
        wire, operand = wire_and_operand(t.kind, t.result_bytes, n)
        ops.append(CollectiveOp(
            kind=t.kind, result_bytes=t.result_bytes, operand_bytes=operand,
            wire_bytes=wire, groups=t.groups, pairs=(), channel_id=channel,
            line_no=t.line_no,
            multiplier=counts[key] * (grad_accum if t.micro else 1)))
    return ops


def unfolded(traced: list[Traced]) -> list[CollectiveOp]:
    """Each traced collective as an op of its own, multiplier 1."""
    ops = []
    for channel, t in enumerate(traced, 1):
        n = max(len(g) for g in t.groups)
        wire, operand = wire_and_operand(t.kind, t.result_bytes, n)
        ops.append(CollectiveOp(
            kind=t.kind, result_bytes=t.result_bytes, operand_bytes=operand,
            wire_bytes=wire, groups=t.groups, pairs=(), channel_id=channel,
            line_no=t.line_no))
    return ops


def cell_collectives(cell) -> tuple[list[CollectiveOp], dict]:
    """The folded collectives of a built cell (``specs.build_cell``) and
    the trace's facts: seconds, graph nodes, collectives traced."""
    import time

    t0 = time.perf_counter()
    gm = trace(cell.fn, cell.args)
    seconds = time.perf_counter() - t0
    traced = read_graph(gm, MeshGroups(cell.mesh))
    A = cell.train.grad_accum if cell.train is not None else 1
    ops = fold(traced, paths(cell.args[0]), A)
    return ops, {"trace_s": seconds, "graph_nodes": len(gm.graph.nodes),
                 "traced_collectives": len(traced), "folded_ops": len(ops)}
