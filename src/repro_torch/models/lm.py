"""The decoder-only LM, dense and SSM branches: the port of the dense
and Mamba-2 parts of ``repro/models/lm.py``.

Parameters are plain nested dicts of tensors in the reference's (in,
out) layout, so ``x @ w`` is the reference's einsum.  Where the reference
stacks layers on a leading L axis and scans them, the port keeps one dict
per layer in a list and loops in Python.  The decode caches keep the
reference's stacked layouts, and each layer writes its slice in place:
dense {"k", "v"}: (L, B, Smax, Hkv, hd); SSM {"conv_x", "conv_B",
"conv_C"}: (L, B, K-1, ·) in the parameter type and "state": (L, B, H,
N, hd) in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from .attention import gqa_forward, init_gqa
from .common import InitCtx, rms_norm, swiglu
from .ssm import init_mamba2, mamba2_cache_spec, mamba2_forward


def check_supported(cfg: ArchConfig) -> None:
    """The port runs dense GQA LMs with RoPE and tied embeddings, and
    Mamba-2 (SSD) LMs with an untied lm_head."""
    if cfg.family == "ssm":
        if cfg.ssm is None or cfg.ssm.variant != "ssd" or cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: the port runs SSM LMs of the Mamba-2 (ssd) "
                f"variant with an untied lm_head")
        return
    if (cfg.family != "dense" or cfg.moe or cfg.mla or cfg.qkv_bias
            or cfg.mrope_sections or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense GQA LMs with tied embeddings "
            f"(family 'dense', no MoE, MLA, qkv bias or M-RoPE) and Mamba-2 "
            f"SSM LMs")


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


def _ssm_layer_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    return {"mixer": init_mamba2(ctx, cfg),
            "ln1": ctx.make((cfg.d_model,), scale="embed")}


def _ssm_layer(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
               cache=None) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, _ = mamba2_forward(p["mixer"], cfg, h, cache=cache)
    return x + out


def init_lm(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random weights at the reference's scales, drawn on the
    generator's device."""
    check_supported(cfg)
    ctx = InitCtx(generator=generator, dtype=cfg.param_dtype())
    params = {
        "embed": ctx.make((cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": ctx.make((cfg.d_model,), scale="embed"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ctx.make((cfg.d_model, cfg.vocab))
    layer = _ssm_layer_params if cfg.family == "ssm" else _dense_layer_params
    params["layers"] = [layer(ctx, cfg) for _ in range(cfg.num_layers)]
    return params


def _embed(params: dict, batch: dict) -> torch.Tensor:
    return params["embed"][batch["tokens"]]


def _unembed(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


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
        lc = None if caches is None else {k: c[i] for k, c in caches.items()}
        if cfg.family == "ssm":                  # cache_index plays no part
            x = _ssm_layer(lp, cfg, x, cache=lc)
        else:
            x = _dense_layer(lp, cfg, x, positions=positions, cache=lc,
                             cache_index=cache_index, window=window)
    if last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), caches


def cache_specs(cfg: ArchConfig, batch: int,
                max_len: int) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of the decode cache, the reference's
    stacked layout (an SSM's does not grow with ``max_len``)."""
    if cfg.family == "ssm":
        return {k: ((cfg.num_layers, *shape), dt)
                for k, (shape, dt) in mamba2_cache_spec(cfg, batch).items()}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": (shape, cfg.param_dtype()), "v": (shape, cfg.param_dtype())}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_specs(cfg, batch, max_len).items()}
