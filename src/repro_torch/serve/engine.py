"""Batched serving: prefill and a token-by-token decode loop over the
model's decode cache (a step-indexed KV cache for attention, MLA's
latent cache, the conv and state caches for Mamba-2).  The port of
``repro/serve/engine.py``.

The cache is written in place, as the reference's jitted step donates
it.  Sampling draws from an explicit ``torch.Generator`` where the
reference takes a JAX key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.model import Model


@dataclasses.dataclass
class ServeEngine:
    model: Model
    batch_size: int
    max_len: int

    def init_cache(self) -> dict:
        return self.model.init_cache(self.batch_size, self.max_len)

    def prefill_logits(self, params: dict, batch: dict) -> torch.Tensor:
        return self.model.prefill(params, batch)

    def generate(self, params: dict, prompt_tokens: torch.Tensor, steps: int,
                 *, extra_batch: Optional[dict] = None,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 return_logits: bool = False):
        """Greedy or sampled generation.  prompt_tokens: (B, S0) integers.
        Feeds the prompt token by token through decode (cache-exact), then
        generates ``steps`` tokens: returns (B, S0 + steps) int64, and with
        ``return_logits`` also the (B, steps, V) logits each new token was
        chosen from (the first is the last prompt position's).  Samples
        at ``temperature`` > 0 when a generator is given, else greedy.
        ``extra_batch`` joins every step's batch unchanged, as in the
        reference: the encoder's ``enc_memory``, or ``mrope_positions``
        (the same positions at every step)."""
        B, S0 = prompt_tokens.shape
        if B != self.batch_size:
            raise ValueError(f"{B} prompts for an engine of batch_size "
                             f"{self.batch_size}")
        prompt = prompt_tokens.to(device=self.model.device, dtype=torch.int64)
        cache = self.init_cache()
        out, chosen_from = [prompt], []
        tok = None
        extra = extra_batch or {}
        for i in range(S0 + steps - 1):
            cur = prompt[:, i:i + 1] if i < S0 else tok
            logits, cache = self.model.decode_step(
                params, cache, {"tokens": cur, **extra}, i)
            last = logits[:, -1]
            if temperature > 0 and generator is not None:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = last.argmax(dim=-1, keepdim=True)
            if i >= S0 - 1:
                out.append(tok)
                if return_logits:
                    chosen_from.append(last)
        tokens = torch.cat(out, dim=1)
        if return_logits:
            return tokens, torch.stack(chosen_from, dim=1)
        return tokens
