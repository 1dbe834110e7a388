"""Mamba-2 (SSD) layers: the port of the Mamba-2 half of
``repro/models/ssm.py`` (Mamba-1, for jamba, waits for that family).

Projections are separate weights (w_z, w_x, w_B, w_C, w_dt) in the
reference's (in, out) layout.  A prefill runs the chunked SSD scan; a
decode step advances the (H, d_state, head_dim) state by one token.

``ssd_chunked`` routes as ``attention.attention_any`` routes the flash
op: a CUDA tensor goes to ``kernels.ssd.ops.ssd_scan`` (the intra-chunk
part in the CUDA kernel, the inter-chunk scan in torch ops); a CPU
tensor takes the plain twin of the reference's ``ssd_chunked``, which
materialises every chunk's (Q, Q) decay matrix.  The reference's model
calls only its XLA twin; its Pallas kernel is reached only through its
``kernels/ssd/ops.py``.

Rounding follows the reference: dt, A and the state are f32; the
convolutions, gates and projections run in the parameter type; the
decays are exponents masked before the exp; ``w`` rounds to x's type
before ``w @ x``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssd.ops import ssd_scan
from .common import InitCtx, rms_norm

NEG = -1e30


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq.  x: (B, S, C); w: (K, C); b: (C,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, k:k + S, :] * w[k] for k in range(K))
    return out + b


def _conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv.  state: (B, K-1, C) last inputs; x_t: (B, 1, C).
    Returns (the new state, y (B, 1, C))."""
    window = torch.cat([state, x_t], dim=1)                  # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return window[:, 1:, :], y[:, None, :]


def ssm_dims(cfg: ArchConfig) -> tuple[int, int]:
    """(d_inner, SSD heads) of a Mamba-2 config."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


def init_mamba2(ctx: InitCtx, cfg: ArchConfig) -> dict:
    s = cfg.ssm
    D, N, K = cfg.d_model, s.d_state, s.d_conv
    d_inner, H = ssm_dims(cfg)
    return {
        "w_z": ctx.make((D, d_inner)),
        "w_x": ctx.make((D, d_inner)),
        "w_B": ctx.make((D, N)),
        "w_C": ctx.make((D, N)),
        "w_dt": ctx.make((D, H)),
        "conv_x_w": ctx.make((K, d_inner), scale=0.3),
        "conv_x_b": ctx.make((d_inner,), zero=True),
        "conv_B_w": ctx.make((K, N), scale=0.3),
        "conv_B_b": ctx.make((N,), zero=True),
        "conv_C_w": ctx.make((K, N), scale=0.3),
        "conv_C_b": ctx.make((N,), zero=True),
        "A_log": ctx.const(torch.log(torch.linspace(1.0, 16.0, H))),
        "D": ctx.const(torch.ones(H)),
        "dt_bias": ctx.const(torch.zeros(H)),
        "norm": ctx.make((d_inner,), scale="embed"),
        "out_proj": ctx.make((d_inner, D)),
    }


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan from a zero state (the reference's ``state_in``, which no
    caller passes, is not ported).  x: (B, S, H, hd); dt: (B, S, H); A:
    (H,) negative; Bm/Cm: (B, S, N).  Returns (y: (B, S, H, hd),
    state_out: (B, H, N, hd) f32).  A CUDA tensor runs the kernel
    (``ssd_scan``)."""
    if x.device.type == "cuda":
        return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    Bsz, S, H, hd = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = x.shape[1]
    nc = Sp // chunk
    xc = x.reshape(Bsz, nc, chunk, H, hd)
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    a = dtc * A                                                  # (B,nc,Q,H)
    cum = torch.cumsum(a, dim=2)
    # intra-chunk quadratic form, the exponent masked BEFORE the exp
    dcum = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,nc,i,j,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], dcum, NEG))
    scores = torch.einsum("bcin,bcjn->bcij", Cc.float(), Bc.float())
    w = scores[..., None] * Lmat * dtc[:, :, None, :, :]         # (B,nc,i,j,H)
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", w.to(x.dtype), xc)

    # chunk-local states and the inter-chunk scan
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,Q,H)
    Sloc = torch.einsum("bcjn,bcjh,bcjhd->bchnd", Bc.float(),
                        dtc * decay_to_end, xc.float())          # (B,nc,H,N,hd)
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B,nc,H)
    state = torch.zeros((Bsz, H, N, hd), dtype=torch.float32,
                        device=x.device)
    states_prev = []                                 # the state BEFORE chunk c
    for c in range(nc):
        states_prev.append(state)
        state = chunk_decay[:, c, :, None, None] * state + Sloc[:, c]
    prev = torch.stack(states_prev, dim=1)                       # (B,nc,H,N,hd)

    y_inter = torch.einsum("bcin,bcih,bchnd->bcihd", Cc.float(),
                           torch.exp(cum), prev)
    y = (y_intra.float() + y_inter).reshape(Bsz, Sp, H, hd)
    if pad:
        y = y[:, :S]
    return y.to(x.dtype), state


def mamba2_forward(p: dict, cfg: ArchConfig, xin: torch.Tensor, *,
                   cache: Optional[dict] = None
                   ) -> tuple[torch.Tensor, Optional[dict]]:
    """xin: (B, S, D) -> (B, S, D), and the cache when one is given.

    cache (decode, S == 1): {"conv_x", "conv_B", "conv_C"}: (B, K-1, ·)
    in the parameter type and "state": (B, H, N, hd) f32, written in
    place; the same dict comes back."""
    s = cfg.ssm
    B, S, _ = xin.shape
    d_inner, H = ssm_dims(cfg)

    z = xin @ p["w_z"]
    x_raw = xin @ p["w_x"]
    B_raw = xin @ p["w_B"]
    C_raw = xin @ p["w_C"]
    dt = F.softplus((xin @ p["w_dt"]).float() + p["dt_bias"])   # (B,S,H)
    A = -torch.exp(p["A_log"])

    if cache is None:
        xs = F.silu(_causal_conv(x_raw, p["conv_x_w"], p["conv_x_b"]))
        Bm = F.silu(_causal_conv(B_raw, p["conv_B_w"], p["conv_B_b"]))
        Cm = F.silu(_causal_conv(C_raw, p["conv_C_w"], p["conv_C_b"]))
        xh = xs.reshape(B, S, H, s.head_dim)
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, chunk=s.chunk)
    else:
        if S != 1:
            raise ValueError(f"a cached Mamba-2 call takes one token, got {S}")
        outs = []
        for name, raw in (("x", x_raw), ("B", B_raw), ("C", C_raw)):
            window, y_t = _conv_step(cache[f"conv_{name}"], raw,
                                     p[f"conv_{name}_w"], p[f"conv_{name}_b"])
            cache[f"conv_{name}"].copy_(window)
            outs.append(F.silu(y_t))
        xs, Bm, Cm = outs
        xh = xs.reshape(B, 1, H, s.head_dim)
        dec = torch.exp(dt[:, 0] * A)                                # (B,H)
        upd = (dt[:, 0, :, None, None] * Bm[:, 0, None, :, None].float()
               * xh[:, 0, :, None, :].float())                       # (B,H,N,hd)
        state = cache["state"]
        torch.addcmul(upd, dec[..., None, None], state, out=state)
        y = (Cm[:, 0, None, None, :].float() @ state)[:, :, 0]       # (B,H,hd)
        y = y[:, None].to(xin.dtype)                                 # (B,1,H,hd)

    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], cache


def mamba2_cache_spec(cfg: ArchConfig, batch: int
                      ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    s = cfg.ssm
    dt = cfg.param_dtype()
    d_inner, H = ssm_dims(cfg)
    return {
        "conv_x": ((batch, s.d_conv - 1, d_inner), dt),
        "conv_B": ((batch, s.d_conv - 1, s.d_state), dt),
        "conv_C": ((batch, s.d_conv - 1, s.d_state), dt),
        "state": ((batch, H, s.d_state, s.head_dim), torch.float32),
    }
