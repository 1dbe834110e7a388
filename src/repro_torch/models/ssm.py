"""Mamba layers: the port of ``repro/models/ssm.py``, Mamba-2 (SSD, for
mamba2-1.3b) and Mamba-1 (the selective scan, for the Jamba hybrid).

Projections are separate weights in the reference's (in, out) layout.
A Mamba-2 prefill runs the chunked SSD scan and a decode step advances
the (H, d_state, head_dim) state by one token; a Mamba-1 prefill runs
the selective scan over time and a decode step advances its (d_inner,
d_state) state by one token.

``ssd_chunked`` routes as ``attention.attention_any`` routes the flash
op: a CUDA tensor goes to ``SSDScan``, whose forward is
``kernels.ssd.ops.ssd_scan`` (the intra-chunk part in the CUDA kernel,
the inter-chunk scan in torch ops) and whose backward differentiates
``ssd_twin`` recomputed; a CPU tensor takes ``ssd_twin``, the plain twin
of the reference's ``ssd_chunked``, which materialises every chunk's
(Q, Q) decay matrix.  The reference's model calls only its XLA twin
(``jax.grad`` differentiates it); its Pallas kernel is reached only
through its ``kernels/ssd/ops.py``.  Mamba-1's prefill scan is
``SelectiveScan``: forward ``kernels.selective_scan.ops.selective_scan``,
backward ``selective_scan_bwd``, each the CUDA kernel on a CUDA tensor
and the plain version (the reference's step loop, its reverse
recurrence) in torch ops on a CPU tensor.

Rounding follows the reference: dt, A and the state are f32; the
convolutions, gates and projections run in the parameter type; the
decays are exponents masked before the exp; ``w`` rounds to x's type
before ``w @ x``.  Mamba-1's state update rounds ``dA · h`` and then the
sum, on the card too (no fused multiply-add), in both the kernel and
the decode step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.selective_scan.ops import selective_scan, selective_scan_bwd
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
    (``SSDScan``), a CPU tensor ``ssd_twin``."""
    if x.device.type == "cuda":
        return SSDScan.apply(x, dt, A, Bm, Cm, chunk)
    return ssd_twin(x, dt, A, Bm, Cm, chunk=chunk)


def ssd_twin(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's XLA ``ssd_chunked`` in torch ops, on any device
    and differentiable: ``ssd_chunked``'s arguments and results."""
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


class SSDScan(torch.autograd.Function):
    """The SSD scan under autograd.  Forward: ``kernels.ssd.ops.ssd_scan``
    (on a CUDA tensor the intra-chunk kernel, which launches or raises;
    on a CPU one its plain version).  Backward: the gradient of
    ``ssd_twin`` recomputed on the saved inputs — the path ``jax.grad``
    takes through the reference's XLA ``ssd_chunked`` — with the final
    state's cotangent where it has one.  The kernel's plain version
    never runs in the backward.  Arguments: ``ssd_chunked``'s, then the
    chunk; dx, ddt, dA, dB and dC come back in their inputs' types."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            y, state = ssd_twin(*leaves, chunk=ctx.chunk)
            outs = [(o, g) for o, g in ((y, gy), (state, gstate))
                    if g is not None]
            grads = torch.autograd.grad([o for o, _ in outs],
                                        leaves, [g for _, g in outs],
                                        allow_unused=True)
        return (*(torch.zeros_like(t) if g is None else g
                  for t, g in zip(inputs, grads)), None)


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


# -- Mamba-1 (the selective scan; Jamba's sublayers) --------------------------


def mamba1_dims(cfg: ArchConfig) -> tuple[int, int]:
    """(d_inner, dt_rank) of a Mamba-1 config: dt_rank = ceil(D / 16)."""
    return cfg.ssm.expand * cfg.d_model, math.ceil(cfg.d_model / 16)


def init_mamba1(ctx: InitCtx, cfg: ArchConfig) -> dict:
    s = cfg.ssm
    D, N, K = cfg.d_model, s.d_state, s.d_conv
    d_inner, R = mamba1_dims(cfg)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32))
    return {
        "w_x": ctx.make((D, d_inner)),
        "w_z": ctx.make((D, d_inner)),
        "conv_w": ctx.make((K, d_inner), scale=0.3),
        "conv_b": ctx.make((d_inner,), zero=True),
        "x_proj": ctx.make((d_inner, R + 2 * N)),
        "dt_proj": ctx.make((R, d_inner)),
        "dt_bias": ctx.const(torch.zeros(d_inner)),
        "A_log": ctx.const(A_log.expand(d_inner, N).contiguous()),
        "D": ctx.const(torch.ones(d_inner)),
        "out_proj": ctx.make((d_inner, D)),
    }


class SelectiveScan(torch.autograd.Function):
    """Mamba-1's selective scan under autograd.  Forward:
    ``kernels.selective_scan.ops.selective_scan``; backward: its
    ``selective_scan_bwd``, given y's cotangent and the final state's
    where it has one.  Each is the CUDA kernel on a CUDA tensor (it
    launches or raises) and the plain version on a CPU tensor.
    Arguments and results: ``selective_scan``'s; dx, dB and dC come back
    in their inputs' types, ddt and dA in f32."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return selective_scan(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, gy, gh):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, dA, dB, dC = selective_scan_bwd(
            x, dt, A, Bm, Cm, gy.float(), None if gh is None else gh.float())
        return dx.to(x.dtype), ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype)


def mamba1_forward(p: dict, cfg: ArchConfig, xin: torch.Tensor, *,
                   cache: Optional[dict] = None
                   ) -> tuple[torch.Tensor, Optional[dict]]:
    """xin: (B, S, D) -> (B, S, D), and the cache when one is given.

    cache (decode): {"conv": (B, K-1, d_inner) in the parameter type,
    "state": (B, d_inner, N) f32}, written in place; the same dict comes
    back.  A cached call takes one token: the reference's cache branch
    reads position 0 of a longer input and drops the rest, which the
    port refuses."""
    B, S, _ = xin.shape
    N = cfg.ssm.d_state
    _, R = mamba1_dims(cfg)
    if cache is not None and S != 1:
        raise ValueError(f"a cached Mamba-1 call takes one token, got {S}")

    x = xin @ p["w_x"]
    z = xin @ p["w_z"]
    if cache is None:
        x = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))
    else:
        window, y_conv = _conv_step(cache["conv"], x, p["conv_w"],
                                    p["conv_b"])
        cache["conv"].copy_(window)
        x = F.silu(y_conv)

    dt_low, Bm, Cm = (x @ p["x_proj"]).split([R, N, N], dim=-1)
    dt = F.softplus((dt_low @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                   # (d_inner, N)
    if cache is None:
        y, _ = SelectiveScan.apply(x, dt, A, Bm, Cm)             # (B, S, d_inner)
    else:
        dt_t = dt[:, 0, :, None]                                 # (B, d_inner, 1)
        dA = torch.exp(dt_t * A)
        dBx = dt_t * Bm[:, 0, None, :].float() * x[:, 0, :, None].float()
        state = cache["state"]
        state.mul_(dA).add_(dBx)            # dA * h, rounded, then + dBx
        y = torch.einsum("bin,bn->bi", state, Cm[:, 0].float())[:, None]

    y = y.to(xin.dtype) + p["D"].to(xin.dtype) * x
    y = y * F.silu(z.float()).to(y.dtype)
    return y @ p["out_proj"], cache


def mamba1_cache_spec(cfg: ArchConfig, batch: int
                      ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    s = cfg.ssm
    d_inner, _ = mamba1_dims(cfg)
    return {
        "conv": ((batch, s.d_conv - 1, d_inner), cfg.param_dtype()),
        "state": ((batch, d_inner, s.d_state), torch.float32),
    }
