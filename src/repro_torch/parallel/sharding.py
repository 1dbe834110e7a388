"""Sharding rules: a spec per parameter leaf by name, activation and
cache specs, with divisibility guards.  The port of
``repro/parallel/sharding.py``.

A *spec* is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dim, each ``None``, a mesh-axis name or a tuple of names.
``to_placements`` turns one into DTensor ``Shard``/``Replicate``
placements on a mesh of the port's (``step_mesh``).

Baseline layout (as the reference's "what a production mesh does"):
  * batch over ('pod', 'data');
  * tensor parallel over 'model': attention heads (the packed H*hd dim),
    the FFN hidden, the MoE expert FFN width, the SSM d_inner/heads and
    the vocab, each only where it divides;
  * optional FSDP: large leaves also sharded over 'data' on a non-model
    dim, within a pod: replicated over 'pod'.

A step's DTensors live on two meshes over the same ranks: the batch and
the leaves that no spec shards over 'data' alone on the flattened
('pod_data', 'model') mesh (``step_mesh``), so that a reduction over the
batch axes is one collective; the leaves that FSDP or ZeRO-2 shards over
'data' on its root, the ('pod', 'data', 'model') mesh, replicated over
'pod' (``place``).  ``unshard`` gathers such a leaf and
moves it to the step mesh; ``on_mesh`` moves a gradient between the two
without a collective.

The trees differ.  The reference stacks layers on a leading L axis; the
port keeps a list of per-layer dicts (and the hybrid a list of periods,
each with lists of sublayers).  Each enclosing list is one of the
reference's stacked axes, so a layer leaf's spec here is the reference's
spec of the stacked leaf with its leading entries dropped: the FSDP size
threshold reads the stacked size, and a leaf whose FSDP shard would land
on a stacked axis raises, naming the leaf, since the port has no such
axis to shard.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Any, Iterator, Optional

import torch

# leaf-name -> (negative dim index to shard over 'model'), from the END of
# the shape so stacked layer axes don't matter
_MODEL_DIM_RULES: dict[str, int] = {
    # attention
    "wq": -1, "wk": -1, "wv": -1, "wo": -2,
    "bq": -1, "bk": -1, "bv": -1,
    # mlp
    "w_gate": -1, "w_up": -1, "w_down": -2,
    "w_in": -1, "b_in": -1, "w_out": -2,
    # mla
    "w_uk": -1, "w_uv": -1,
    # ssm (unpacked projections)
    "w_z": -1, "w_x": -1, "w_dt": -1,
    "conv_x_w": -1, "conv_x_b": -1, "conv_w": -1, "conv_b": -1,
    "x_proj": -2, "dt_proj": -1, "A_log": -1, "dt_bias": -1,
    "out_proj": -2, "norm": -1,
    # embeddings
    "embed": -2, "lm_head": -1,
}
# mamba1 A_log is (d_inner, N) -> shard -2; mamba2 A_log is (H,) -> -1.
# Disambiguated by rank at application time (see _model_dim).

_REPLICATED = {"router", "w_dkv", "kv_norm", "w_B", "w_C", "conv_B_w",
               "conv_B_b", "conv_C_w", "conv_C_b", "D",
               "ln1", "ln2", "ln", "ln1b", "ln2b", "lnx", "lnxb",
               "final_norm", "final_norm_b", "enc_final_norm_b", "efnb", "fnb",
               "b_out"}

Spec = tuple


def is_dtensor(t) -> bool:
    """True for a DTensor (without importing DTensor where no caller made
    one: then none exists)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


@contextlib.contextmanager
def plain_as_replicated(tree: Any) -> Iterator[None]:
    """Where ``tree``'s first leaf is a DTensor: DTensor's implicit
    replication (the tensors a forward makes itself, positions, rotary
    tables, an aux loss's zero, taken as replicated over the mesh) for
    the block, the flag restored after it, so that a backward (and its
    checkpoint recomputes) inside an outer block keeps it."""
    first = tree
    while isinstance(first, (dict, list)):
        first = next(iter(first.values())) if isinstance(first, dict) \
            else first[0]
    if not is_dtensor(first):
        yield
        return
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def _model_dim(name: str, shape: tuple[int, ...]) -> Optional[int]:
    if name == "A_log":
        return -2 if len(shape) >= 2 and shape[-1] <= 256 and shape[-2] > shape[-1] \
            else -1
    if name == "D" or name == "dt_bias":
        return -1
    return _MODEL_DIM_RULES.get(name)


def leaf_spec(name: str, shape: tuple[int, ...], *, model_axis: str = "model",
              model_size: int, fsdp_axis: Optional[str] = None,
              fsdp_size: int = 1, fsdp_min_size: int = 1 << 22,
              attention_shardable: bool = True) -> Spec:
    """The reference's ``param_specs`` rule for one leaf of ``shape``
    (the stacked shape, where the reference stacks it) named ``name``."""
    ndim = len(shape)
    dims: list[Any] = [None] * ndim
    if name in _REPLICATED or ndim == 0:
        return tuple(dims)
    md = _model_dim(name, shape)
    if name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv") and not attention_shardable:
        md = None
    if name == "A_log" and ndim == 1:
        md = -1
    if md is not None and shape[md] % model_size == 0:
        dims[md] = model_axis
    # FSDP: shard the largest remaining dim of big leaves over data
    if fsdp_axis and math.prod(shape) >= fsdp_min_size:
        cands = [d for d in range(ndim)
                 if dims[d] is None and shape[d] % fsdp_size == 0 and shape[d] > 1]
        if cands:
            best = max(cands, key=lambda d: shape[d])
            dims[best] = fsdp_axis
    return tuple(dims)


def _walk(tree: Any, fn, path: tuple = (), stack: tuple = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, stack, leaf)``:
    ``path`` the dict keys and list indices down to it, ``stack`` the
    lengths of the lists that enclose it (the reference's stacked axes)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,), stack) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (i,), stack + (len(tree),))
                for i, v in enumerate(tree)]
    return fn(path, stack, tree)


def _leaf_name(path: tuple) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def param_specs(params: Any, *, model_axis: str = "model", model_size: int,
                fsdp_axis: Optional[str] = None, fsdp_size: int = 1,
                fsdp_min_size: int = 1 << 22,
                attention_shardable: bool = True) -> Any:
    """A spec per leaf of the port's parameter tree (leaves: anything with
    a ``shape``), equal to the reference's spec of the stacked leaf with
    the stacked axes' entries dropped.  attention_shardable=False
    replicates the attention projections (whisper: 20 heads don't divide
    the model axis, and sharding the packed dim would split heads)."""

    def spec_for(path, stack, leaf):
        shape = (*stack, *tuple(leaf.shape))
        spec = leaf_spec(_leaf_name(path), shape, model_axis=model_axis,
                         model_size=model_size, fsdp_axis=fsdp_axis,
                         fsdp_size=fsdp_size, fsdp_min_size=fsdp_min_size,
                         attention_shardable=attention_shardable)
        if any(e is not None for e in spec[:len(stack)]):
            raise NotImplementedError(
                f"{'/'.join(map(str, path))}: the reference shards its "
                f"stacked layer axis ({spec}); the port keeps one tensor a "
                f"layer and has no such axis to shard")
        return spec[len(stack):]

    return _walk(params, spec_for)


def fsdp_min_off_stack(params: Any, *, model_size: int, fsdp_size: int = 1,
                       attention_shardable: bool = True) -> int:
    """The least ``fsdp_min_size`` at which ``param_specs`` with FSDP
    raises for no leaf of ``params``: one more than the largest stacked
    leaf whose FSDP shard would land on a stacked layer axis (the MoE's
    q/k/v biases at the reduced widths), or 1 where none would."""
    least = 1

    def look(path, stack, leaf):
        nonlocal least
        shape = (*stack, *tuple(leaf.shape))
        spec = leaf_spec(_leaf_name(path), shape, model_size=model_size,
                         fsdp_axis="data", fsdp_size=fsdp_size,
                         fsdp_min_size=1,
                         attention_shardable=attention_shardable)
        if any(e is not None for e in spec[:len(stack)]):
            least = max(least, math.prod(shape) + 1)
        return leaf

    _walk(params, look)
    return least


def batch_specs(batch_axes: tuple[str, ...] = ("pod", "data")) -> dict[str, Spec]:
    """Input specs by batch-entry name; batch dim over pod+data."""
    b = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    return {
        "tokens": (b, None),
        "labels": (b, None),
        "embeds": (b, None, None),
        "enc_embeds": (b, None, None),
        "enc_memory": (b, None, None),
        "mrope_positions": (None, b, None),
    }


def cache_partition_specs(
    cache_spec_tree: Any, *,
    batch_axes: tuple[str, ...] = ("pod", "data"),
    model_axis: str = "model",
    model_size: int = 1,
    global_batch: int = 0,
    batch_size_total: int = 1,
    seq_axis_for_b1: bool = True,
) -> Any:
    """Specs for decode caches: a tree of (shape, dtype) leaves in the
    reference's stacked layout (``lm.cache_specs``), as the reference
    lays them out:
      * attention k/v (L, B, S, Hkv, hd): B over the batch axes and S
        over 'model' (context parallel); if B == 1, S over the batch axes
        and 'model' together;
      * mla latent (L, B, S, R): B over the batch axes, S over 'model';
      * ssm conv/state: B over the batch axes, d_inner/H over 'model'
        where it divides.
    ``global_batch`` is the reference's and reads nothing."""
    b = batch_axes if len(batch_axes) > 1 else batch_axes[0]

    def spec_for(path, leaf):
        shape, _ = leaf
        name = _leaf_name(path)
        ndim = len(shape)
        dims: list[Any] = [None] * ndim
        if name in ("k", "v"):
            B_dim, S_dim = ndim - 4, ndim - 3
            if shape[B_dim] == 1 and seq_axis_for_b1:
                both = (*batch_axes, model_axis)
                if shape[S_dim] % (batch_size_total * model_size) == 0:
                    dims[S_dim] = both
                elif shape[S_dim] % model_size == 0:
                    dims[S_dim] = model_axis
            else:
                if shape[B_dim] % batch_size_total == 0:
                    dims[B_dim] = b
                if shape[S_dim] % model_size == 0:
                    dims[S_dim] = model_axis
        elif name == "latent":
            B_dim, S_dim = ndim - 3, ndim - 2
            if shape[B_dim] % batch_size_total == 0:
                dims[B_dim] = b
            if shape[S_dim] % model_size == 0:
                dims[S_dim] = model_axis
        elif name.startswith("conv"):
            B_dim, C_dim = ndim - 3, ndim - 1
            if shape[B_dim] % batch_size_total == 0:
                dims[B_dim] = b
            if shape[C_dim] % model_size == 0 and shape[C_dim] >= model_size * 16:
                dims[C_dim] = model_axis
        elif name == "state":
            if "mamba" in path:   # jamba mamba1: (..., B, d_inner, N)
                B_dim, H_dim = ndim - 3, ndim - 2
            else:                 # mamba2 SSD: (..., B, H, N, hd)
                B_dim, H_dim = ndim - 4, ndim - 3
            if shape[B_dim] % batch_size_total == 0:
                dims[B_dim] = b
            if shape[H_dim] % model_size == 0:
                dims[H_dim] = model_axis
        return tuple(dims)

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        return spec_for(path, t)

    return walk(cache_spec_tree)


def mesh_axes(mesh) -> list[tuple[str, ...]]:
    """The reference axes each dim of a port mesh covers: a dim named
    "a_b" (``DeviceMesh._flatten``'s name for a and b flattened) covers
    ("a", "b")."""
    return [tuple(n.split("_")) for n in mesh.mesh_dim_names]


def step_mesh(mesh):
    """The 2-D ('data' or 'pod_data', 'model') mesh the step's batch and
    whole leaves live on, over the same ranks as ``mesh``: a 2-D mesh
    itself; on a 3-D ('pod', 'data', 'model') one, its batch axes
    flattened C-order into one dim by ``DeviceMesh._flatten``, so that a
    reduction over the batch axes is one collective, and the mesh keeps
    ``mesh`` as its root (``root_mesh``).  Made once a root and kept on
    it: a traced step asks again for its leaves' mesh, and slicing a
    mesh there fails on torch 2.11, which slices with tensor ops."""
    import warnings

    if mesh.ndim == 2:
        return mesh
    made = getattr(mesh, "_step_mesh", None)
    if made is not None:
        return made
    names = mesh.mesh_dim_names
    if names[-1] != "model":
        raise ValueError(f"the model axis must be the last, not {names}")
    flat = "_".join(names[:-1])
    mesh[names[:-1]]._flatten(flat)
    with warnings.catch_warnings():
        # torch asks callers to hold the flattened mesh: the root does
        warnings.filterwarnings("ignore", "Slicing a flattened dim")
        mesh._step_mesh = mesh[(flat, "model")]
    return mesh._step_mesh


def root_mesh(mesh):
    """The mesh ``mesh`` was sliced from (``step_mesh``'s 3-D mesh), or
    ``mesh`` itself."""
    return mesh._get_root_mesh()


def _entry_names(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(d)`` on the
    mesh dim whose axes tensor dim ``d`` names, ``Replicate`` on the rest.
    An entry names every axis of one dim: on the two-pod step mesh
    ('pod_data', 'model') the batch's ("pod", "data") shards over
    'pod_data', and FSDP's "data" alone has no dim there (``place``
    puts such a leaf on the root mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    covers = mesh_axes(mesh)
    out: list = [Replicate()] * len(covers)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = _entry_names(entry)
        dims = {i for i, c in enumerate(covers) for n in names if n in c}
        if len(dims) != 1 or set(covers[min(dims)]) != set(names):
            raise ValueError(f"spec entry {entry!r} maps to mesh dims "
                             f"{sorted(dims)} of {mesh.mesh_dim_names}; it "
                             f"must name the axes of exactly one")
        (i,) = dims
        if not isinstance(out[i], Replicate):
            raise ValueError(f"spec {spec} shards two tensor dims over mesh "
                             f"dim {mesh.mesh_dim_names[i]!r}")
        out[i] = Shard(d)
    return tuple(out)


def place(mesh, spec: Spec) -> tuple:
    """(the mesh, its placements) for a leaf of ``spec`` on the step mesh
    ``mesh``: ``mesh`` itself, unless an entry names some but not all of
    a flattened dim's axes (FSDP's and ZeRO-2's "data" on ('pod_data',
    'model')): then the root mesh, on which the leaf is replicated over
    'pod', as the reference shards it."""
    covers = mesh_axes(mesh)
    part = any(set(_entry_names(e)) & set(c) and
               not set(c) <= set(_entry_names(e))
               for e in spec if e is not None for c in covers)
    if part:
        if root_mesh(mesh) is mesh:
            raise ValueError(f"spec {spec} shards over part of a dim of "
                             f"{mesh.mesh_dim_names}, a mesh with no root "
                             f"(step_mesh)")
        mesh = root_mesh(mesh)
    return mesh, to_placements(mesh, spec)


def placements_on(src, placements, dst) -> tuple:
    """``placements`` on mesh ``src`` as placements on ``dst``, a mesh
    over the same ranks whose dims flatten or split ``src``'s: each dim
    of ``dst`` takes the placement of the ``src`` dims that share its
    axes, which must agree ('pod' and 'data' both ``Replicate``, both
    ``Partial`` or both ``Shard(d)`` for 'pod_data'; a ``Shard(d)`` on
    'pod_data' splits evenly as 'pod' then 'data')."""
    src_c, dst_c = mesh_axes(src), mesh_axes(dst)
    out = []
    for c in dst_c:
        got = [placements[i] for i, s in enumerate(src_c) if set(s) & set(c)]
        if not got or any(g != got[0] for g in got):
            raise ValueError(f"placements {placements} on "
                             f"{src.mesh_dim_names} have no counterpart on "
                             f"{dst.mesh_dim_names}")
        out.append(got[0])
    return tuple(out)


def _moved(t: torch.Tensor, mesh) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    pl = placements_on(t.device_mesh, t.placements, mesh)
    return DTensor.from_local(t.to_local(), mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def on_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """DTensor ``t`` on ``mesh`` (``placements_on``), with no collective
    and no gradient: a gradient partial over 'pod_data' moves to the pod
    mesh as partial over 'pod' and 'data', an accumulator gathered over
    'data' to the step mesh."""
    return t if t.device_mesh == mesh else _moved(t, mesh)


def reduce_to(t: torch.Tensor, placements) -> torch.Tensor:
    """DTensor ``t`` redistributed to ``placements`` in two steps: first
    every mesh dim that ends as a shard (a reduce-scatter of a partial
    sum, or a slice), then the rest, so that an all-reduce (over 'pod',
    of a gradient sharded over 'data') moves only this rank's shard, as
    XLA orders them.  DTensor's own order may all-reduce the whole
    tensor first."""
    mid = tuple(q if q.is_shard() else p
                for p, q in zip(t.placements, placements))
    if mid != t.placements:
        t = t.redistribute(t.device_mesh, mid)
    return t if t.placements == tuple(placements) else \
        t.redistribute(t.device_mesh, placements)


class _Unshard(torch.autograd.Function):
    """FSDP's gather: a root mesh leaf redistributed to ``placements`` and
    moved to the step mesh; its gradient moves back and is reduced to
    the leaf's placements by ``reduce_to``."""

    @staticmethod
    def forward(ctx, t, placements, mesh):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return _moved(t.redistribute(t.device_mesh, placements), mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_to(_moved(g, ctx.mesh), ctx.placements), None, None


def unshard(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """DTensor leaf ``t`` gathered to ``placements`` on its own mesh and
    moved to the step mesh ``mesh`` (``_Unshard``)."""
    if tuple(placements) == t.placements and t.device_mesh == mesh:
        return t
    return _Unshard.apply(t, tuple(placements), mesh)


def map_specs(fn, tree: Any, specs: Any) -> Any:
    """``tree`` with each leaf replaced by ``fn(leaf, spec)``, ``specs``
    a tree of ``tree``'s structure with a spec (a tuple) at each leaf."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def local_part(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` under ``placements``,
    cut here without a collective (every rank holds ``t``): DTensor's own
    ``Shard`` split, so uneven dims split as DTensor splits them."""
    for i, p in enumerate(placements):
        if p.is_shard():
            pieces, _ = p._split_tensor(t, mesh.size(i), with_padding=False)
            t = pieces[mesh.get_local_rank(i)]
    return t.contiguous()


def shard_tree(tree: Any, mesh, specs: Any) -> Any:
    """Every whole tensor of ``tree`` (the same on every rank, as drawn
    from one seed) as a DTensor on the step mesh ``mesh`` (or its root,
    ``place``) placed by its spec."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        m, pl = place(mesh, spec)
        return DTensor.from_local(local_part(t, m, pl), m, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    return map_specs(one, tree, specs)


def strip_axis(spec: Spec, axis: str) -> Spec:
    """``spec`` with ``axis`` taken out of every entry (the reference's
    FSDP per-layer unshard: a layer's TP-only spec)."""
    def keep(e):
        if e is None or e == axis:
            return None
        if isinstance(e, tuple):
            rest = tuple(n for n in e if n != axis)
            return rest if len(rest) > 1 else (rest[0] if rest else None)
        return e
    return tuple(keep(e) for e in spec)
