"""AdamW over the port's parameter trees, with a configurable state
dtype: the port of ``repro/train/optimizer.py``.

The arithmetic is the reference's, rounding where it rounds: every step
in f32 on the parameters' device (no value goes to the host), the first
and second moments stored in ``state_dtype`` (``"bfloat16"`` halves the
optimizer's memory), global-norm clipping, decoupled weight decay on
matrices only (leaves of two or more dimensions), and each new parameter
cast back to its own type.  ``torch.optim.AdamW`` decays every leaf and
rounds at other points, so it is not used.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import leaves, rebuild


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # or "bfloat16" for big models
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``: an f32
    scalar on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """{"m", "v": zeros of each parameter's shape in ``state_dtype``,
    "step": int32 0}, on the parameters' device."""
    flat = leaves(params)

    def zeros():
        return rebuild(params, [torch.zeros(p.shape, dtype=_state_dtype(cfg),
                                            device=p.device) for p in flat])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, in f32, summed leaf by leaf."""
    total = None
    for x in leaves(tree):
        s = x.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig
                 ) -> tuple[object, dict, dict]:
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}).

    ``params`` and the moments are updated in place and returned (the
    reference returns new arrays, whose old ones a jitted caller
    donates): a second copy of a 2.5 B-parameter model's weights and
    moments would not fit beside them on the card.  ``state["step"]`` is
    replaced by the incremented step."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    clip = (torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
            if cfg.grad_clip > 0 else one)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.full_like(one, cfg.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(one, cfg.b2), stepf)
    sdt = _state_dtype(cfg)
    flat = zip(leaves(params), leaves(grads), leaves(state["m"]),
               leaves(state["v"]))
    for p, g, m, v in flat:
        g = g.float() * clip
        m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + g.square_() * (1 - cfg.b2)
        del g
        delta = (m32 / b1c) / ((v32 / b2c).sqrt_() + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2 and cfg.weight_decay > 0:
            delta = delta + p.float() * cfg.weight_decay
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m32.to(sdt))
        v.copy_(v32.to(sdt))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
