"""Per-cell build logic: the port of ``repro/launch/specs.py``.  For an
(arch x shape x mesh) cell it gives the sharded step, stand-ins for its
inputs and the same ``meta`` as the reference.

The stand-ins are ``FakeTensorMode`` tensors with each rank's local
shapes: no memory is allocated, so qwen2-72b's cell builds on a laptop.
``CellBuild.fn`` takes them, places them as DTensors on the step mesh
(``launch.mesh.step_mesh``) and runs the sharded step (``train``: one
microbatch's loss and gradient into the accumulator, then the update;
``prefill``: the last position's logits), returning local tensors, so
that ``make_fx`` traces the ranks' own program with its collectives.

The port builds the ``train`` and ``prefill`` cells of the dense family
and of the MoE family without MLA (expert parallel, ``impl="ep"``, as
the reference's cells default to).  Every other cell raises, naming its
family or shape: ``decode`` and ``long_500k`` need context-parallel
caches (the attention cache's sequence sharded over 'model', with the
softmax partials reduced), and MLA and the SSM, hybrid, VLM and
encoder-decoder families have sharded forwards the port does not have
yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.lm import RematPolicy
from ..models.model import Model
from ..parallel.sharding import (
    local_part, map_specs, param_specs, place, strip_axis,
)
from ..train.optimizer import AdamWConfig
from ..train.step import TrainConfig
from .mesh import batch_axes, mesh_shape, step_mesh

#: the families and shape kinds the port shards
SHARDED_FAMILIES = ("dense", "moe")
SHARDED_KINDS = ("train", "prefill")
#: training shards the parameters by FSDP from this many on (the
#: reference's ``fsdp_threshold_params`` default)
FSDP_MIN_PARAMS = 10_000_000_000


@dataclasses.dataclass
class CellBuild:
    arch: ArchConfig
    shape: ShapeConfig
    fn: Callable                     # fn(*args): the sharded step, locals out
    args: tuple                      # FakeTensorMode stand-ins, local shapes
    mesh: Any                        # the step mesh
    model: Model
    specs: Any                       # the parameters' spec tree
    train: TrainConfig | None
    meta: dict


def count_params_tree(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params_tree(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params_tree(v) for v in tree)
    return int(math.prod(tree.shape))


def active_params(cfg: ArchConfig, total: int) -> int:
    """Active params per token for the 6*N*D MODEL_FLOPS convention."""
    if not cfg.moe:
        return total
    e = cfg.moe
    expert_p = 3 * cfg.d_model * e.d_ff_expert
    n_moe_layers = (cfg.num_layers - e.first_dense_layers)
    if e.every_k_layers > 1:
        n_moe_layers = cfg.num_layers // e.every_k_layers
    inactive = n_moe_layers * (e.num_experts - e.top_k) * expert_p
    return total - inactive


def pick_grad_accum(cfg: ArchConfig, shape: ShapeConfig, data_shards: int) -> int:
    """Default: microbatch of one sequence per data shard (the
    reference's rule)."""
    return max(1, shape.global_batch // data_shards)


def check_cell(arch: ArchConfig, shape: ShapeConfig) -> None:
    """Raise, naming the family or the shape, for a cell the port does
    not shard."""
    if shape.kind not in SHARDED_KINDS:
        raise NotImplementedError(
            f"{arch.name} x {shape.name}: the port shards {SHARDED_KINDS} "
            f"cells; {shape.kind} cells need context-parallel caches")
    if arch.family not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"{arch.name} x {shape.name}: the port shards the "
            f"{SHARDED_FAMILIES} families; family {arch.family!r} has no "
            f"sharded forward yet")
    if arch.mla:
        raise NotImplementedError(
            f"{arch.name} x {shape.name}: family {arch.family!r} with MLA "
            f"attention has no sharded forward yet")


def fake_params(model: Model):
    """The model's parameters as ``FakeTensorMode`` tensors (whole
    shapes, no memory), and the mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        return model.init(0), mode


def _batch(cfg: ArchConfig, shape: ShapeConfig, *, with_labels: bool) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int64)}
    if with_labels:
        batch["labels"] = torch.zeros((B, S), dtype=torch.int64)
    return batch


def build_cell(arch: ArchConfig, shape: ShapeConfig, mesh) -> CellBuild:
    """The cell on ``mesh`` (a production mesh, ``launch.mesh``), with the
    reference's family defaults: dense archs pin the residual stream
    batch-sharded in training; MoE archs run expert parallel; FSDP at
    >= ``FSDP_MIN_PARAMS`` params in training; AdamW state in bf16 above
    100e9 params; ZeRO-2 accumulators without FSDP.  FSDP and ZeRO-2
    shard over 'data' within a pod (``parallel.sharding.place``)."""
    check_cell(arch, shape)
    if arch.moe:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, impl="ep"))
    shape_of = mesh_shape(mesh)
    model_size = shape_of["model"]
    data_shards = math.prod(n for a, n in shape_of.items()
                            if a in ("pod", "data"))
    baxes = batch_axes(mesh)
    b = baxes if len(baxes) > 1 else baxes[0]
    smesh = step_mesh(mesh)
    # FSDP and ZeRO-2 shard within a pod, as the reference's do
    fsdp_size = shape_of["data"]

    model = Model(arch, device="cpu",
                  remat=RematPolicy(enabled=shape.kind == "train",
                                    policy="nothing_saveable"))
    p_fake, mode = fake_params(model)
    n_params = count_params_tree(p_fake)
    n_active = active_params(arch, n_params)
    use_fsdp = n_params >= FSDP_MIN_PARAMS and shape.kind == "train"
    attn_ok = arch.num_heads % model_size == 0
    pspec = param_specs(
        p_fake, model_size=model_size,
        fsdp_axis="data" if use_fsdp else None,
        fsdp_size=fsdp_size, attention_shardable=attn_ok)

    hooks = {}
    if use_fsdp:
        # FSDP per-layer unshard: each layer's leaves gathered to their
        # TP-only placements at use, one layer at a time
        hooks["layer_specs"] = map_specs(lambda _, s: strip_axis(s, "data"),
                                         pspec["layers"][0],
                                         pspec["layers"][0])
    if shape.kind == "train" and arch.moe is None:
        hooks["act_spec"] = (b, None, None)
    model = dataclasses.replace(model, **hooks)

    meta = {
        "arch": arch.name, "shape": shape.name, "kind": shape.kind,
        "params": n_params, "active_params": n_active, "fsdp": use_fsdp,
        "mesh": shape_of, "attention_tp": attn_ok,
    }

    with mode:
        p_local = map_specs(lambda t, s: local_part(t, *place(smesh, s)),
                            p_fake, pspec)

    if shape.kind == "train":
        opt_state_dtype = "bfloat16" if n_params > 100_000_000_000 else "float32"
        accum = pick_grad_accum(arch, shape, data_shards)
        meta["grad_accum"] = accum
        meta["opt_state_dtype"] = opt_state_dtype
        accum_specs = None
        if not use_fsdp:
            accum_specs = param_specs(
                p_fake, model_size=model_size, fsdp_axis="data",
                fsdp_size=fsdp_size, fsdp_min_size=1 << 20,
                attention_shardable=attn_ok)
        tc = TrainConfig(optimizer=AdamWConfig(state_dtype=opt_state_dtype),
                         grad_accum=accum, batch_axes=baxes,
                         accum_specs=accum_specs)
        opt_dt = (torch.bfloat16 if opt_state_dtype == "bfloat16"
                  else torch.float32)
        with mode:
            moments = map_specs(lambda t, s: t.to(opt_dt), p_local, pspec)
            opt = {"m": moments,
                   "v": map_specs(lambda t, s: t.clone(), moments, pspec),
                   "step": torch.zeros((), dtype=torch.int32)}
            batch = _batch(arch, shape, with_labels=True)
        from .collectives import train_program
        fn = train_program(model, tc, smesh, pspec)
        args = (p_local, opt, batch)
    else:
        with mode:
            batch = _batch(arch, shape, with_labels=False)
        from .collectives import prefill_program
        fn = prefill_program(model, smesh, pspec)
        args = (p_local, batch)
        tc = None
    return CellBuild(arch=arch, shape=shape, fn=fn, args=args, mesh=smesh,
                     model=model, specs=pspec, train=tc, meta=meta)
