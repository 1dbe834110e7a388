"""Mixture-of-Experts: a softmax top-k router, sort-based capacity
dispatch and a fused shared expert.  The port of ``repro/models/moe.py``.

Dispatch is batch-local, as in the reference (there a ``vmap`` over the
batch rows; here a batch axis written out): each row's tokens are
routed, sorted by expert and cut at the expert's capacity on their own.
Capacity is ``max(1, ceil(T * k / E * capacity_factor))`` tokens an
expert per row, T the row's length, and a token past it is dropped
(GShard's rule), so what drops depends on the sequence length.

Three places where the port pins the reference's order:

* top-k ties: the router's logits come out of a product in the working
  type, so equal logits are common; the k experts are the head of a
  stable descending sort, which puts the lower expert id first, as
  ``jax.lax.top_k`` does;
* the combine: the reference scatter-adds a token's k contributions in
  ascending expert id, rounding each step to the working type; the port
  folds each token's k slots in that order with plain adds (no atomics),
  so the card gives the same bits from run to run;
* the expert buffer is laid out expert-major, (E, B·C, D), so the expert
  products are batched matrix products over E with no copy; the
  reference's (B, E, C, D) einsums compute the same sums.

``impl="ep"`` only constrains the reference's sharding and is a no-op on
one device; the port takes no mesh and runs it as ``"tp"``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import InitCtx, swiglu


def init_moe(ctx: InitCtx, cfg: ArchConfig) -> dict:
    """Router (D, E), experts (E, D, F) / (E, F, D) and, with
    ``num_shared``, one shared expert of width ``num_shared * F``."""
    e = cfg.moe
    D, F_, E = cfg.d_model, e.d_ff_expert, e.num_experts
    p = {
        "router": ctx.make((D, E)),
        # fan-in is each expert's input width, not the expert axis
        "w_gate": ctx.make((E, D, F_), scale=D ** -0.5),
        "w_up": ctx.make((E, D, F_), scale=D ** -0.5),
        "w_down": ctx.make((E, F_, D), scale=F_ ** -0.5),
    }
    if e.num_shared:
        Fs = e.num_shared * F_
        p["shared"] = {"w_gate": ctx.make((D, Fs)), "w_up": ctx.make((D, Fs)),
                       "w_down": ctx.make((Fs, D))}
    return p


def capacity(cfg: ArchConfig, tokens_per_row: int) -> int:
    """Slots an expert takes in each batch row (the reference's rule)."""
    e = cfg.moe
    return max(1, math.ceil(tokens_per_row * e.top_k / e.num_experts
                            * e.capacity_factor))


def _route(probs: torch.Tensor, top_k: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(weights, expert ids), each (B, T, k): a token's k most probable
    experts, ties to the lower id, weights renormalised to sum 1."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[..., :top_k], idx[..., :top_k]
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9), idx


def _dispatch(x: torch.Tensor, idx: torch.Tensor, C: int, E: int):
    """The reference's ``_dispatch_one_row`` over every row at once.

    x: (B, T, D); idx: (B, T, k).  Returns the expert buffer (E, B·C, D)
    and each slot's rank within its expert, (B, T, k), in idx's order.
    Each row's T·k slots are sorted stably by expert id, so an expert
    takes its tokens in token order; a slot of rank ≥ C is dropped."""
    B, T, k = idx.shape
    D = x.shape[-1]
    fe = idx.reshape(B, T * k)
    order = torch.argsort(fe, dim=-1, stable=True)
    se = torch.gather(fe, 1, order)                       # sorted expert ids
    arange_e = torch.arange(E, device=x.device).expand(B, E).contiguous()
    starts = torch.searchsorted(se, arange_e, side="left")          # (B, E)
    pos = (torch.arange(T * k, device=x.device)
           - torch.gather(starts, 1, se))                 # rank in expert
    b = torch.arange(B, device=x.device)[:, None]
    trash = E * B * C                     # where every dropped slot lands
    rows = torch.where(pos < C, (se * B + b) * C + pos, trash)
    buf = x.new_zeros((trash + 1, D))
    buf[rows.reshape(-1)] = x[b, order // k].reshape(-1, D)
    rank = torch.empty_like(pos).scatter_(1, order, pos)   # back to idx order
    return buf[:trash].view(E, B * C, D), rank.view(B, T, k)


def _combine(out: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
             rank: torch.Tensor, C: int) -> torch.Tensor:
    """The reference's ``_combine_one_row`` over every row at once.

    out: (E, B·C, D) expert outputs; w, idx, rank: (B, T, k).  Each
    token's k weighted outputs (a dropped slot weighs 0) are summed in
    ascending expert id, one rounding to out's type a step."""
    B, T, k = idx.shape
    E = out.shape[0]
    eid, perm = torch.sort(idx, dim=-1)                   # distinct ids
    rank = torch.gather(rank, 2, perm)
    keep = rank < C
    w = (torch.gather(w, 2, perm) * keep).to(out.dtype)
    rows = ((eid * B + torch.arange(B, device=out.device)[:, None, None]) * C
            + torch.where(keep, rank, 0))
    vals = out.view(E * B * C, -1)[rows.reshape(-1)].view(B, T, k, -1)
    contrib = vals * w[..., None]
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


def moe_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                with_aux: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x: (B, S, D) -> (y (B, S, D) in x's type, the Switch-style
    load-balance aux loss, an f32 scalar, or None without ``with_aux``:
    serving has no use for it)."""
    e = cfg.moe
    B, S, _ = x.shape
    E, C = e.num_experts, capacity(cfg, S)

    logits = (x @ p["router"]).float()                    # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = _route(probs, e.top_k)
    buf, rank = _dispatch(x, idx, C, E)
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    del buf
    h = F.silu(g).mul_(u)
    del g, u
    y = _combine(torch.bmm(h, p["w_down"]), w, idx, rank, C)

    aux = None
    if with_aux:
        # E * sum_e f_e * p_e: f_e the share of tokens whose top expert is e
        top1 = logits.argmax(dim=-1)[..., None]
        f = (top1 == torch.arange(E, device=x.device)).float().mean(dim=(0, 1))
        aux = E * torch.sum(f * probs.mean(dim=(0, 1)))

    if "shared" in p:
        sp = p["shared"]
        y = y + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.to(x.dtype), aux
