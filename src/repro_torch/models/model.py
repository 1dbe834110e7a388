"""Public model API for serving: the port of ``repro/models/model.py``
(the loss and its cross-entropy come with training)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..device import generator as make_generator
from ..device import resolve_device
from .lm import check_supported, init_cache, init_lm, lm_forward, run_encoder


@dataclasses.dataclass(frozen=True)
class Model:
    """``device=None`` runs on the CUDA card and raises on a host without
    one; ``device="cpu"`` runs on the host."""

    cfg: ArchConfig
    device: Optional[torch.device] = None

    def __post_init__(self):
        check_supported(self.cfg)
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- parameters --------------------------------------------------------
    def init(self, seed: int) -> dict:
        """Random weights drawn on this model's device from ``seed``."""
        return init_lm(self.cfg, make_generator(seed, self.device))

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, *,
                last_only: bool = False) -> torch.Tensor:
        """Full-sequence forward: logits (B, S, V), or (B, 1, V) with
        last_only (serving needs only the next-token distribution)."""
        logits, _ = lm_forward(params, self.cfg, batch, last_only=last_only)
        return logits

    @torch.no_grad()
    def encode(self, params: dict, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder-decoder's encoder over frame embeddings (B, Se, D):
        the memory that ``batch["enc_memory"]`` hands to the decoder, so
        that prefill and each decode step skip the encoder."""
        if self.cfg.family != "encdec":
            raise ValueError(f"{self.cfg.name} has no encoder")
        return run_encoder(params, self.cfg, enc_embeds)

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
        logits, caches = lm_forward(
            params, self.cfg, batch, caches=caches, cache_index=cache_index,
            window_override=win or 0)
        return logits, caches

    # -- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, self.device)
