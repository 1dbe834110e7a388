"""Attention: grouped-query attention with RoPE or M-RoPE and optional
q/k/v biases, DeepSeek-V2's multi-head latent attention (MLA, with the
absorbed decode) and the encoder-decoder's cross-attention.  The port
of ``repro/models/attention.py``.

Three ways to attend, routed by ``attention_any`` as the reference
routes them:

* long windowless self-attention with one head dim for q, k and v goes
  to the flash-attention op (``kernels/flash_attention``: the CUDA
  kernel on a CUDA tensor, its plain version on a CPU tensor), where
  the reference runs its XLA twin of the Pallas kernel,
  ``chunked_attention``; under autograd through ``FlashAttention``,
  whose backward differentiates ``chunked_attention`` as the reference
  does;
* long self-attention that the kernel does not take goes to
  ``chunked_attention``: windowed, or with a v head dim other than
  q's and k's (MLA's prefill: 192 against 128), as the reference runs
  it;
* everything else — decode against a cache, short sequences, the
  encoder's 1,500 frames, cross-attention — goes to ``plain_attention``.

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
from .common import InitCtx, apply_rope, mrope_tables, rms_norm, rope_tables

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


def cache_mask(cache_index: int, S: int, max_len: int, window: int,
               device) -> torch.Tensor:
    """(S, max_len) mask of S queries written from slot ``cache_index``
    over a cache of ``max_len`` slots: causal, which also masks the
    slots not written yet.  A decode step computes it once for all its
    layers."""
    return _mask(cache_index + torch.arange(S, device=device),
                 torch.arange(max_len, device=device), causal=True,
                 window=window)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int, window: int = 0,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Materialised-scores attention.  q: (B, Sq, H, hd); k, v: (B, Sk,
    Hkv, hd).  ``q_offset`` is the absolute position of q[:, 0] for the
    causal mask; ``mask``, where given, is that (Sq, Sk) mask."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    if mask is None:
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


class FlashAttention(torch.autograd.Function):
    """The flash op under autograd.  Forward: ``kernels.flash_attention.
    ops.flash_attention`` (the kernel on a CUDA tensor, which launches or
    raises; its plain version on a CPU one).  Backward: the gradient of
    ``chunked_attention`` — the port of the reference's XLA path, the one
    ``jax.grad`` differentiates there — recomputed on the saved q, k, v.
    The kernel's plain version never runs on the card.  q: (B, S, H,
    hd); k, v: (B, S, Hkv, hd), strided as ``attention_any`` gets them;
    dq, dk and dv come back in those shapes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        # (B, S, H, hd) views as (B, H, S, hd): the kernel reads strides
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = chunked_attention(*leaves, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None


def attention_any(q, k, v, *, causal, q_offset=0, window=0):
    """Long self-attention to the flash op (or, windowed or with v's head
    dim apart from q's, to ``chunked_attention``); everything else to
    ``plain_attention``."""
    if q.shape[1] > 1 and k.shape[1] > LONG_SEQ and q.shape[1] == k.shape[1]:
        if window > 0 or v.shape[-1] != q.shape[-1]:
            return chunked_attention(q, k, v, causal=causal, window=window)
        return FlashAttention.apply(q, k, v, causal)
    return plain_attention(q, k, v, causal=causal, q_offset=q_offset,
                           window=window)


def rotary_tables(cfg: ArchConfig, positions: torch.Tensor,
                  mrope_positions: Optional[torch.Tensor],
                  head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables a layer rotates by: M-RoPE's where the
    config has sections and the batch gives their positions (3, B, S),
    else 1-D RoPE's at ``positions``, over ``head_dim``."""
    if cfg.mrope_sections and mrope_positions is not None:
        return mrope_tables(mrope_positions, cfg.mrope_sections, head_dim,
                            cfg.rope_theta)
    return rope_tables(positions, head_dim, cfg.rope_theta)


def _check_write(cache_index: Optional[int], S: int, max_len: int) -> None:
    """A cached call names the slot it writes, and its S tokens fit."""
    if cache_index is None:
        raise ValueError("a cached call needs cache_index")
    if not 0 <= cache_index <= max_len - S:
        raise ValueError(
            f"cache write of {S} token(s) at {cache_index} runs past "
            f"max_len {max_len}")


def init_gqa(ctx: InitCtx, cfg: ArchConfig) -> dict:
    hd, H, Hkv, D = cfg.hd, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    p = {
        "wq": ctx.make((D, H * hd)),
        "wk": ctx.make((D, Hkv * hd)),
        "wv": ctx.make((D, Hkv * hd)),
        "wo": ctx.make((H * hd, D)),
    }
    if cfg.qkv_bias:                        # zero at init, as the reference
        p["bq"] = ctx.make((H * hd,), zero=True)
        p["bk"] = ctx.make((Hkv * hd,), zero=True)
        p["bv"] = ctx.make((Hkv * hd,), zero=True)
    return p


def gqa_forward(
    p: dict, cfg: ArchConfig, x: torch.Tensor, *,
    positions: torch.Tensor,                 # (S,) or (B, S) absolute positions
    causal: bool = True,
    window: int = 0,
    mrope_positions: Optional[torch.Tensor] = None,   # (3, B, S)
    cache: Optional[dict] = None,            # {"k","v"}: (B, Smax, Hkv, hd)
    cache_index: Optional[int] = None,       # first slot this call writes
    rope: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Self-attention, causal unless ``causal=False`` (the encoder).
    x: (B, S, D) -> (B, S, D), and the cache when one is given.  A config
    with M-RoPE sections given ``mrope_positions`` rotates by those, as
    the reference does, else by ``positions``.  ``rope`` (the rotation's
    tables) and, with a cache, ``mask`` (``cache_mask``) are computed
    here unless the caller computed them once for all layers.

    The cache is written in place (the reference's engine donates it, so
    its update is in place on the device too) and the same dict comes
    back.  A write past the cache's length raises, where the reference's
    ``dynamic_update_slice`` would clamp it quietly.
    """
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        # the product rounds to x's type before the bias is added, as in
        # the reference (a fused bias epilogue would add it in f32 first)
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if rope is None:
        rope = rotary_tables(cfg, positions, mrope_positions, hd)
    q = apply_rope(q, positions, cfg.rope_theta, tables=rope)
    k = apply_rope(k, positions, cfg.rope_theta, tables=rope)

    if cache is None:
        out = attention_any(q, k, v, causal=causal, window=window)
    else:
        _check_write(cache_index, S, cache["k"].shape[1])
        cache["k"][:, cache_index:cache_index + S] = k
        cache["v"][:, cache_index:cache_index + S] = v
        # causal with q_offset doubles as the valid-length mask: slots
        # past cache_index + S - 1 hold stale data and stay masked
        out = plain_attention(q, cache["k"], cache["v"], causal=True,
                              q_offset=cache_index, window=window, mask=mask)
    y = out.reshape(B, S, H * hd) @ p["wo"]
    return y, cache


def init_mla(ctx: InitCtx, cfg: ArchConfig) -> dict:
    """MLA's weights: q (D, H·(nope + rope)), the KV down-projection to
    the latent and the shared rotary key (D, lora + rope), the latent's
    RMS scale, the per-head up-projections of k and v from the latent,
    and the output."""
    m = cfg.mla
    H, D = cfg.num_heads, cfg.d_model
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": ctx.make((D, H * qk)),
        "w_dkv": ctx.make((D, m.kv_lora_rank + m.qk_rope_dim)),
        "kv_norm": ctx.make((m.kv_lora_rank,), scale="embed"),
        "w_uk": ctx.make((m.kv_lora_rank, H * m.qk_nope_dim)),
        "w_uv": ctx.make((m.kv_lora_rank, H * m.v_head_dim)),
        "wo": ctx.make((H * m.v_head_dim, D)),
    }


def mla_forward(
    p: dict, cfg: ArchConfig, x: torch.Tensor, *,
    positions: torch.Tensor,                 # (S,) absolute positions
    cache: Optional[dict] = None,            # {"latent": (B, Smax, lora + rope)}
    cache_index: Optional[int] = None,
    rope: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """DeepSeek-V2's multi-head latent attention, causal.  RoPE turns the
    ``qk_rope_dim`` dims of q and the one rotary key shared by all heads
    (``rope``: ``rope_tables`` at that width, not ``cfg.hd``).

    Without a cache (prefill) the latent is decompressed per head and q,
    k of nope + rope (192) attend over v of ``v_head_dim`` (128) through
    ``attention_any``, which sends a long one to ``chunked_attention``.
    With a cache (decode) the absorbed form: the cache holds latent ++
    rotary key (B, Smax, lora + rope), ``w_uk`` is folded into q, the
    weighted sum is taken over the latent and ``w_uv`` applied after it.
    Its rounding points are the reference's: the two score products are
    summed in x's type and only then cast to f32, the scale is 1/√(nope
    + rope), and the probabilities are cast to x's type before the
    latent product.  ``mask``: ``cache_mask`` (windowless), where made
    once for all layers.
    """
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rd, dv, lora = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                          m.kv_lora_rank)
    if rope is None:
        rope = rope_tables(positions, rd, cfg.rope_theta)
    q = (x @ p["wq"]).reshape(B, S, H, nope + rd)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, tables=rope)
    dkv = x @ p["w_dkv"]                                   # (B, S, lora + rope)
    latent = rms_norm(dkv[..., :lora], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, lora:], positions, tables=rope)

    if cache is None:
        k_nope = (latent @ p["w_uk"]).reshape(B, S, H, nope)
        v = (latent @ p["w_uv"]).reshape(B, S, H, dv)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], dim=-1)
        out = attention_any(torch.cat([q_nope, q_rope], dim=-1), k, v,
                            causal=True)
        return out.reshape(B, S, H * dv) @ p["wo"], None

    cl = cache["latent"]
    _check_write(cache_index, S, cl.shape[1])
    cl[:, cache_index:cache_index + S] = torch.cat([latent, k_rope[:, :, 0]],
                                                   dim=-1)
    c_lat, c_rope = cl[..., :lora], cl[..., lora:]
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope,
                         p["w_uk"].reshape(lora, H, nope))
    scores = (torch.einsum("bshl,btl->bhst", q_lat, c_lat)
              + torch.einsum("bshr,btr->bhst", q_rope, c_rope)).float()
    scores = scores * (1.0 / math.sqrt(nope + rd))
    if mask is None:
        mask = cache_mask(cache_index, S, cl.shape[1], 0, x.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhst,btl->bshl", probs, c_lat)   # (B, S, H, lora)
    out = torch.einsum("bshl,lhv->bshv", ctx_lat,
                       p["w_uv"].reshape(lora, H, dv))
    return out.reshape(B, S, H * dv) @ p["wo"], cache


def init_cross(ctx: InitCtx, cfg: ArchConfig) -> dict:
    hd, H, D = cfg.hd, cfg.num_heads, cfg.d_model
    return {
        "wq": ctx.make((D, H * hd)),
        "wk": ctx.make((D, H * hd)),
        "wv": ctx.make((D, H * hd)),
        "wo": ctx.make((H * hd, D)),
    }


def cross_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  memory: torch.Tensor) -> torch.Tensor:
    """Cross-attention of the decoder states x (B, S, D) over the
    encoder's memory (B, Se, D), not causal, no rotation.  K and V are
    projected from the memory on every call: the reference caches
    neither."""
    B, S, _ = x.shape
    Se = memory.shape[1]
    hd, H = cfg.hd, cfg.num_heads
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (memory @ p["wk"]).reshape(B, Se, H, hd)
    v = (memory @ p["wv"]).reshape(B, Se, H, hd)
    out = plain_attention(q, k, v, causal=False, q_offset=0)
    return out.reshape(B, S, H * hd) @ p["wo"]
