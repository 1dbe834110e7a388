"""The train step: loss and gradient, optional microbatch accumulation,
global-norm clipping and AdamW.  The port of ``repro/train/step.py``.

The step runs where the parameters are (the card unless the model was
made with ``device="cpu"``) and reads nothing back to the host: its
metrics are device scalars.  The reference's ``batch_axes`` and
``accum_specs`` pin shardings; the port has one device and takes
neither.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models.model import Model
from ..tree import leaves, rebuild
from .optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_accum: int = 1               # microbatches per step


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
    loss, metrics = model.loss(live, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            rebuild(params, grads))


def make_train_step(model: Model, tc: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  Batch leaves lead with the global batch (the
    M-RoPE positions with their stream axis first); with ``grad_accum``
    A > 1 the batch splits into A microbatches of consecutive rows,
    whose gradients sum in f32 and whose mean loss is the step's.
    ``params`` and ``opt_state`` are updated in place and returned."""
    A = tc.grad_accum
    if A < 1:
        raise ValueError(f"grad_accum must be at least 1, got {A}")

    def train_step(params, opt_state, batch):
        device = leaves(params)[0].device
        batch = {k: _on(v, device) for k, v in batch.items()}
        if A == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            B = batch["labels"].shape[0]
            if B % A:
                raise ValueError(f"global batch {B} does not split into "
                                 f"{A} microbatches")
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                     for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(A):
                mb = {k: _micro(v, B, A, i) for k, v in batch.items()}
                mloss, _, mgrads = loss_and_grads(model, params, mb)
                for acc, g in zip(grads, leaves(mgrads)):
                    acc.add_(g.float())
                del mgrads
                loss = loss + mloss
            for acc in grads:
                acc.div_(A)
            loss, metrics, grads = loss / A, {}, rebuild(params, grads)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, tc.optimizer)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def init_train_state(model: Model, tc: TrainConfig, seed: int):
    """(parameters drawn from ``seed`` on the model's device, a fresh
    AdamW state for them)."""
    params = model.init(seed)
    return params, adamw_init(params, tc.optimizer)
