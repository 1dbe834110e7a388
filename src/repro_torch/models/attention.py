"""Grouped-query attention with RoPE: the port of the GQA half of
``repro/models/attention.py`` (MLA and cross-attention wait for the
families that use them).

Three ways to attend, routed by ``attention_any`` as the reference
routes them:

* long windowless self-attention goes to the flash-attention op
  (``kernels/flash_attention``: the CUDA kernel on a CUDA tensor, its
  plain version on a CPU tensor), where the reference runs its XLA twin
  of the Pallas kernel, ``chunked_attention``;
* long windowed self-attention goes to ``chunked_attention``, which the
  kernel does not take;
* everything else — decode against a cache, short sequences — goes to
  ``plain_attention``.

``plain_attention`` and ``chunked_attention`` copy the reference's
rounding points: in bf16 the q·k scores round to bf16 before the f32
softmax, and ``chunked_attention`` rounds q/√hd to q's type first.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from .common import InitCtx, apply_rope

NEG_INF = -1e30
#: self-attention longer than this takes the flash op (the reference's
#: ``chunk_threshold``)
LONG_SEQ = 2048


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int) -> torch.Tensor:
    """(Sq, Sk) True where query q_pos[i] may attend key k_pos[j]."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int,
                    window: int = 0) -> torch.Tensor:
    """Materialised-scores attention.  q: (B, Sq, H, hd); k, v: (B, Sk,
    Hkv, hd).  ``q_offset`` is the absolute position of q[:, 0] for the
    causal mask."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    mask = _mask(q_offset + torch.arange(Sq, device=q.device),
                 torch.arange(k.shape[1], device=q.device),
                 causal=causal, window=window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax self-attention over key blocks of ``chunk``:
    O(B·H·Sq·chunk) score memory.  Shapes as ``plain_attention``."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = (q.reshape(B, Sq, Hkv, G, hd) * (1.0 / math.sqrt(hd))).to(q.dtype)
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, Sk, chunk):
        kb, vb = k[:, k0:k0 + chunk], v[:, k0:k0 + chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb).float()
        k_pos = k0 + torch.arange(kb.shape[1], device=q.device)
        s = s.masked_fill(~_mask(q_pos, k_pos, causal=causal, window=window),
                          NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb)
        acc = acc * scale[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1])
    return out.to(q.dtype)


def attention_any(q, k, v, *, causal, q_offset=0, window=0):
    """Long self-attention to the flash op (or, windowed, to
    ``chunked_attention``); everything else to ``plain_attention``."""
    if q.shape[1] > 1 and k.shape[1] > LONG_SEQ and q.shape[1] == k.shape[1]:
        if window > 0:
            return chunked_attention(q, k, v, causal=causal, window=window)
        # (B, S, H, hd) views as (B, H, S, hd): the kernel reads strides
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    return plain_attention(q, k, v, causal=causal, q_offset=q_offset,
                           window=window)


def init_gqa(ctx: InitCtx, cfg: ArchConfig) -> dict:
    hd, H, Hkv, D = cfg.hd, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    return {
        "wq": ctx.make((D, H * hd)),
        "wk": ctx.make((D, Hkv * hd)),
        "wv": ctx.make((D, Hkv * hd)),
        "wo": ctx.make((H * hd, D)),
    }


def gqa_forward(
    p: dict, cfg: ArchConfig, x: torch.Tensor, *,
    positions: torch.Tensor,                 # (S,) or (B, S) absolute positions
    window: int = 0,
    cache: Optional[dict] = None,            # {"k","v"}: (B, Smax, Hkv, hd)
    cache_index: Optional[int] = None,       # first slot this call writes
) -> tuple[torch.Tensor, Optional[dict]]:
    """Causal self-attention.  x: (B, S, D) -> (B, S, D), and the cache
    when one is given.

    The cache is written in place (the reference's engine donates it, so
    its update is in place on the device too) and the same dict comes
    back.  A write past the cache's length raises, where the reference's
    ``dynamic_update_slice`` would clamp it quietly.
    """
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = attention_any(q, k, v, causal=True, window=window)
    else:
        if cache_index is None:
            raise ValueError("a cached call needs cache_index")
        max_len = cache["k"].shape[1]
        if not 0 <= cache_index <= max_len - S:
            raise ValueError(
                f"cache write of {S} token(s) at {cache_index} runs past "
                f"max_len {max_len}")
        cache["k"][:, cache_index:cache_index + S] = k
        cache["v"][:, cache_index:cache_index + S] = v
        # causal with q_offset doubles as the valid-length mask: slots
        # past cache_index + S - 1 hold stale data and stay masked
        out = plain_attention(q, cache["k"], cache["v"], causal=True,
                              q_offset=cache_index, window=window)
    y = out.reshape(B, S, H * hd) @ p["wo"]
    return y, cache
