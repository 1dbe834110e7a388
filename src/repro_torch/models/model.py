"""Public model API for training and serving: the port of
``repro/models/model.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..device import generator as make_generator
from ..device import resolve_device
from .lm import (
    NO_REMAT, RematPolicy, check_supported, init_cache, init_lm, lm_forward,
    run_encoder,
)


class CrossEntropy(torch.autograd.Function):
    """Mean token cross-entropy in f32 math over logits kept in their own
    type, the reference's ``custom_vjp``.  It saves the logits as they
    are with their row max ``m`` and ``sumexp``, never an f32 copy of the
    (tokens x vocab) tensor, and its backward gives (g / n_tokens) ·
    (softmax - onehot) cast to the logits' type."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor):
        labels = labels.long()
        lf = logits.float()
        m = lf.amax(dim=-1, keepdim=True)
        sumexp = (lf - m).exp_().sum(dim=-1)
        lse = m[..., 0] + torch.log(sumexp)
        ll = lf.gather(-1, labels[..., None])[..., 0]
        del lf
        ctx.save_for_backward(logits, labels, m[..., 0], sumexp)
        return (lse - ll).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, m, sumexp = ctx.saved_tensors
        # in place: one f32 (tokens x vocab) tensor at a time
        d = logits.float().sub_(m[..., None]).exp_().div_(sumexp[..., None])
        idx = labels[..., None]
        d.scatter_(-1, idx, d.gather(-1, idx) - 1.0)        # p - onehot
        return ((g / labels.numel()) * d).to(logits.dtype), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) in the working type, labels (B, S) integer ->
    the mean token cross-entropy, an f32 scalar."""
    return CrossEntropy.apply(logits, labels)


@dataclasses.dataclass(frozen=True)
class Model:
    """``device=None`` runs on the CUDA card and raises on a host without
    one; ``device="cpu"`` runs on the host.  ``remat`` checkpoints
    training's forward (``loss``); ``moe_aux_weight`` weighs a MoE's
    load-balance loss into it."""

    cfg: ArchConfig
    device: Optional[torch.device] = None
    remat: RematPolicy = RematPolicy()
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        check_supported(self.cfg)
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- parameters --------------------------------------------------------
    def init(self, seed: int) -> dict:
        """Random weights drawn on this model's device from ``seed``."""
        return init_lm(self.cfg, make_generator(seed, self.device))

    # -- training ----------------------------------------------------------
    def loss(self, params: dict, batch: dict
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(loss, {"ce", "moe_aux"}) over ``batch`` (its ``labels`` (B,
        S) beside the forward's keys), differentiable in ``params``: the
        token cross-entropy plus ``moe_aux_weight`` times the summed MoE
        aux loss."""
        logits, _, aux = lm_forward(params, self.cfg, batch,
                                    remat=self.remat, with_aux=True)
        ce = cross_entropy(logits, batch["labels"])
        return ce + self.moe_aux_weight * aux, {"ce": ce, "moe_aux": aux}

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, *,
                last_only: bool = False) -> torch.Tensor:
        """Full-sequence forward: logits (B, S, V), or (B, 1, V) with
        last_only (serving needs only the next-token distribution)."""
        logits, _, _ = lm_forward(params, self.cfg, batch,
                                  last_only=last_only)
        return logits

    @torch.no_grad()
    def encode(self, params: dict, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder-decoder's encoder over frame embeddings (B, Se, D):
        the memory that ``batch["enc_memory"]`` hands to the decoder, so
        that prefill and each decode step skip the encoder."""
        if self.cfg.family != "encdec":
            raise ValueError(f"{self.cfg.name} has no encoder")
        return run_encoder(params, self.cfg, enc_embeds, NO_REMAT)

    @torch.no_grad()
    def decode_step(self, params: dict, caches: dict, batch: dict,
                    cache_index: int, *, window: Optional[int] = None
                    ) -> tuple[torch.Tensor, dict]:
        """One decode step.  batch["tokens"]: (B, 1), and every other
        batch key (``enc_memory``, ``mrope_positions``) passed through.
        Returns (logits (B, 1, V), caches), the caches written in
        place."""
        win = window
        if win is None and self.cfg.sliding_window:
            win = self.cfg.sliding_window
        logits, caches, _ = lm_forward(
            params, self.cfg, batch, caches=caches, cache_index=cache_index,
            window_override=win or 0)
        return logits, caches

    # -- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, self.device)
