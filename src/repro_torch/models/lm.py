"""The decoder-only LM, dense branch: the port of the dense parts of
``repro/models/lm.py``.

Parameters are plain nested dicts of tensors in the reference's (in,
out) layout, so ``x @ w`` is the reference's einsum.  Where the reference
stacks layers on a leading L axis and scans them, the port keeps one dict
per layer in a list and loops in Python.  The decode cache keeps the
reference's stacked layout, {"k", "v"}: (L, B, Smax, Hkv, hd), and each
layer writes its slice in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from .attention import gqa_forward, init_gqa
from .common import InitCtx, rms_norm, swiglu


def check_supported(cfg: ArchConfig) -> None:
    """The port runs dense GQA LMs with RoPE and tied embeddings."""
    if (cfg.family != "dense" or cfg.moe or cfg.mla or cfg.qkv_bias
            or cfg.mrope_sections or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense GQA LMs with tied embeddings "
            f"(family 'dense', no MoE, MLA, qkv bias or M-RoPE)")


def _dense_layer_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "ln1": ctx.make((D,), scale="embed"),
        "ln2": ctx.make((D,), scale="embed"),
        "attn": init_gqa(ctx, cfg),
        "mlp": {"w_gate": ctx.make((D, F)), "w_up": ctx.make((D, F)),
                "w_down": ctx.make((F, D))},
    }


def _dense_layer(p: dict, cfg: ArchConfig, x: torch.Tensor, *, positions,
                 cache=None, cache_index=None, window=0) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, _ = gqa_forward(p["attn"], cfg, h, positions=positions,
                              window=window, cache=cache,
                              cache_index=cache_index)
    x = x + attn_out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])


def init_lm(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random weights at the reference's scales, drawn on the
    generator's device."""
    check_supported(cfg)
    ctx = InitCtx(generator=generator, dtype=cfg.param_dtype())
    return {
        "embed": ctx.make((cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": ctx.make((cfg.d_model,), scale="embed"),
        "layers": [_dense_layer_params(ctx, cfg)
                   for _ in range(cfg.num_layers)],
    }


def _embed(params: dict, batch: dict) -> torch.Tensor:
    return params["embed"][batch["tokens"]]


def _unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embed"].T                 # tied embeddings


def lm_forward(
    params: dict, cfg: ArchConfig, batch: dict, *,
    caches: Optional[dict] = None,
    cache_index: Optional[int] = None,
    window_override: Optional[int] = None,
    last_only: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (logits (B, S, V), caches | None); the caches are updated
    in place.  last_only: unembed only the final position."""
    x = _embed(params, batch)
    S = x.shape[1]
    start = 0 if cache_index is None else cache_index
    positions = start + torch.arange(S, device=x.device)
    window = window_override or 0
    for i, lp in enumerate(params["layers"]):
        lc = None if caches is None else {"k": caches["k"][i],
                                          "v": caches["v"][i]}
        x = _dense_layer(lp, cfg, x, positions=positions, cache=lc,
                         cache_index=cache_index, window=window)
    if last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x), caches


def cache_specs(cfg: ArchConfig, batch: int,
                max_len: int) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of the decode cache, the reference's
    stacked layout."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": (shape, cfg.param_dtype()), "v": (shape, cfg.param_dtype())}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_specs(cfg, batch, max_len).items()}
