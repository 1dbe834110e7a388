"""The train step: loss and gradient, optional microbatch accumulation,
global-norm clipping and AdamW.  The port of ``repro/train/step.py``.

The step runs where the parameters are (the card unless the model was
made with ``device="cpu"``) and reads nothing back to the host: its
metrics are device scalars.

On DTensor parameters (``launch.specs.build_cell``, ``launch.train``) it
is the sharded step: every rank holds the whole global batch (drawn from
one seed), cuts each microbatch's rows out of it and keeps its own part
of them (``batch_axes``: the mesh axes carrying the batch), so that no
collective moves the input.  A microbatch's gradients come out of
DTensor's autograd partial over the batch axes; with ``accum_specs`` (the
reference's ZeRO-2) each is reduce-scattered over 'data' into an f32
accumulator on the root mesh (``parallel.sharding.place``) and all-reduced
over 'pod', and one gather over 'data' at the update brings the sum to
the parameters' placements; without, the sum is kept in the parameters'
placements (one all-reduce a leaf and microbatch, or FSDP's
reduce-scatter and 'pod' all-reduce).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models.model import Model
from ..parallel.sharding import (
    batch_specs, is_dtensor, local_part, mesh_axes, on_mesh,
    place, placements_on, plain_as_replicated, reduce_to, step_mesh,
    to_placements,
)
from ..tree import leaves, rebuild
from .optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_accum: int = 1               # microbatches per step
    # mesh axes carrying the batch dim, read on DTensor parameters (None:
    # every axis of the mesh but 'model')
    batch_axes: Optional[tuple[str, ...]] = None
    # ZeRO-2: a spec tree (matching params) for the f32 gradient
    # accumulator, read on DTensor parameters with grad_accum > 1.
    # Sharding the accumulator over 'data' turns each microbatch's
    # gradient all-reduce into a reduce-scatter and defers the gather to
    # the (single) optimizer update.
    accum_specs: object = None


def _on(x, device: torch.device) -> torch.Tensor:
    """A batch leaf (a tensor or a numpy array) on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _micro(x: torch.Tensor, B: int, A: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``A`` of a batch leaf: its batch axis is the
    first, or for ``mrope_positions`` (3, B, S) the second."""
    b = B // A
    if x.shape[0] == B:
        return x[i * b:(i + 1) * b]
    if x.dim() < 2 or x.shape[1] != B:
        raise ValueError(f"a batch leaf of shape {tuple(x.shape)} has no "
                         f"batch axis of {B}")
    return x[:, i * b:(i + 1) * b]


def loss_and_grads(model: Model, params, batch: dict):
    """(loss, metrics, gradients): ``model.loss`` on ``batch`` (tensors
    on the parameters' device) and its gradient in every parameter, a
    tree of ``params``' structure in the parameters' types (zeros where
    a parameter plays no part)."""
    live = rebuild(params, [p.detach().requires_grad_(True)
                            for p in leaves(params)])
    flat = leaves(live)
    with plain_as_replicated(params):     # the recomputes run in grad
        loss, metrics = model.loss(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (_whole(loss.detach()),
            {k: _whole(v.detach()) for k, v in metrics.items()},
            rebuild(params, grads))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor metric as the plain tensor every rank holds."""
    return t.to_local() if is_dtensor(t) else t


def shard_batch(batch: dict, mesh, batch_axes=None) -> dict:
    """Each whole batch leaf as a DTensor on ``mesh``, this rank keeping
    its part of the batch axis (``batch_specs``), cut without a
    collective: every rank holds the whole batch."""
    from torch.distributed.tensor import DTensor

    if batch_axes is None:
        batch_axes = tuple(a for c in mesh_axes(mesh) for a in c
                           if a != "model")
    specs = batch_specs(batch_axes)
    out = {}
    for k, x in batch.items():
        pl = to_placements(mesh, specs[k])
        out[k] = DTensor.from_local(local_part(x, mesh, pl), mesh, pl,
                                    run_check=False, shape=x.shape,
                                    stride=x.stride())
    return out


def grad_accumulator(params, tc: TrainConfig) -> list[torch.Tensor]:
    """Zeros in f32 for each parameter's gradient sum: a DTensor
    parameter's placed by ``tc.accum_specs`` (ZeRO-2, on the root mesh
    where a spec shards over 'data' alone) where given, else as the
    parameter."""
    flat = leaves(params)
    if not is_dtensor(flat[0]):
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in flat]
    from torch.distributed import tensor as dt

    specs = (leaves(tc.accum_specs) if tc.accum_specs is not None
             else [None] * len(flat))
    out = []
    for p, s in zip(flat, specs):
        mesh, pl = ((p.device_mesh, p.placements) if s is None
                    else place(p.device_mesh, s))
        out.append(dt.zeros(p.shape, dtype=torch.float32, device_mesh=mesh,
                            placements=pl))
    return out


def accumulate(acc: list[torch.Tensor], grads) -> None:
    """Adds one microbatch's gradients (in f32) into ``acc``, each moved
    to its accumulator's mesh and brought to its placements first (a
    reduce-scatter or an all-reduce of a partial DTensor gradient, the
    reduce-scatters first: ``reduce_to``)."""
    for a, g in zip(acc, leaves(grads)):
        g = g.float()
        if is_dtensor(g):
            g = reduce_to(on_mesh(g, a.device_mesh), a.placements)
        a.add_(g)


def placed_like(params, grads):
    """The gradient tree with each DTensor leaf brought to its parameter's
    placements (the update's one gather, or a partial sum's all-reduce)
    and mesh."""
    out = []
    for p, g in zip(leaves(params), leaves(grads)):
        if is_dtensor(g):
            g = on_mesh(reduce_to(g, placements_on(
                p.device_mesh, p.placements, g.device_mesh)), p.device_mesh)
        out.append(g)
    return rebuild(params, out)


def microbatch_step(model: Model, tc: TrainConfig, params, batch: dict,
                    i: int, acc=None):
    """Microbatch ``i`` of ``tc.grad_accum`` cut from the whole batch
    (sharded where the parameters are DTensors): (its loss, its metrics,
    and its gradients, or with ``acc`` (``grad_accumulator``) ``acc``
    with them added)."""
    A = tc.grad_accum
    B = batch["labels"].shape[0]
    if B % A:
        raise ValueError(f"global batch {B} does not split into {A} "
                         f"microbatches")
    mb = batch if A == 1 else {k: _micro(v, B, A, i)
                               for k, v in batch.items()}
    first = leaves(params)[0]
    if is_dtensor(first):      # the batch lives on the step mesh
        mb = shard_batch(mb, step_mesh(first.device_mesh), tc.batch_axes)
    loss, metrics, grads = loss_and_grads(model, params, mb)
    if acc is None:
        return loss, metrics, grads
    accumulate(acc, grads)
    return loss, metrics, acc


def update_step(tc: TrainConfig, params, opt_state, grads):
    """The update after the microbatches: the accumulated sum (a list
    from ``grad_accumulator``) divided by ``grad_accum``, the gradients
    brought to the parameters' placements, AdamW.  Returns (params,
    opt_state, {"grad_norm", "lr"})."""
    if isinstance(grads, list):
        for acc in grads:
            acc.div_(tc.grad_accum)
        grads = rebuild(params, grads)
    return adamw_update(placed_like(params, grads), opt_state, params,
                        tc.optimizer)


def make_train_step(model: Model, tc: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  Batch leaves lead with the global batch (the
    M-RoPE positions with their stream axis first); with ``grad_accum``
    A > 1 the batch splits into A microbatches of consecutive rows,
    whose gradients sum in f32 and whose mean loss is the step's.
    ``params`` and ``opt_state`` are updated in place and returned.  On
    DTensor parameters the step is sharded (see the module's doc)."""
    A = tc.grad_accum
    if A < 1:
        raise ValueError(f"grad_accum must be at least 1, got {A}")

    def train_step(params, opt_state, batch):
        device = leaves(params)[0].device
        batch = {k: _on(v, device) for k, v in batch.items()}
        if A == 1:
            loss, metrics, grads = microbatch_step(model, tc, params, batch,
                                                   0)
        else:
            grads = grad_accumulator(params, tc)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(A):
                mloss, _, grads = microbatch_step(model, tc, params, batch,
                                                  i, grads)
                loss = loss + mloss
            loss, metrics = loss / A, {}
        params, opt_state, opt_metrics = update_step(tc, params, opt_state,
                                                     grads)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def init_train_state(model: Model, tc: TrainConfig, seed: int):
    """(parameters drawn from ``seed`` on the model's device, a fresh
    AdamW state for them)."""
    params = model.init(seed)
    return params, adamw_init(params, tc.optimizer)
