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

On plain tensors ``impl="ep"`` runs as ``"tp"``: it only constrains the
reference's sharding.  On DTensors (the sharded step, ``launch/specs.py``)
the layer runs expert parallel over 'model' (``_sharded_moe``), as the
reference's ``impl="ep"`` cells compile: the dispatch is batch-local on
each rank's rows, every expert weight goes from its width over 'model'
to its experts over 'model' by one all-to-all, each rank runs its own
experts at full width, and the partial combines add over 'model'.  Its
combine order across ranks differs from the unsharded sum's: each rank
adds its own experts' outputs in ascending id, and the all-reduce adds
the ranks' sums.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..parallel.sharding import is_dtensor
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
             rank: torch.Tensor, C: int, first: int = 0) -> torch.Tensor:
    """The reference's ``_combine_one_row`` over every row at once.

    out: (E', B·C, D) the outputs of experts ``first`` to ``first + E'``;
    w, idx, rank: (B, T, k).  Each token's k weighted outputs (a dropped
    slot, or one of an expert not in ``out``, weighs 0) are summed in
    ascending expert id, one rounding to out's type a step.

    With no expert in ``out`` (a rank that holds none: 60 over 16 leaves
    the last one none) the sum is zeros, read from one zero expert of
    weight 0 set after ``out``: the same ops as every other rank's
    combine, so that this rank's backward runs the experts' all-to-alls
    too, and a checkpoint's recompute, which stops once the tensors the
    backward saved are back, stops at the same collective on every
    rank."""
    B, T, k = idx.shape
    if out.shape[0] == 0:
        out = torch.cat([out, out.new_zeros(1, *out.shape[1:])])
    E = out.shape[0]
    eid, perm = torch.sort(idx, dim=-1)                   # distinct ids
    rank = torch.gather(rank, 2, perm)
    eid = eid - first
    inside = (eid >= 0) & (eid < E)
    keep = (rank < C) & inside
    w = (torch.gather(w, 2, perm) * keep).to(out.dtype)
    rows = ((torch.where(inside, eid, 0) * B
             + torch.arange(B, device=out.device)[:, None, None]) * C
            + torch.where(keep, rank, 0))
    vals = out.view(E * B * C, -1)[rows.reshape(-1)].view(B, T, k, -1)
    contrib = vals * w[..., None]
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


def expert_split(E: int, m: int) -> list[int]:
    """Experts a rank holds when E experts shard over m ranks as DTensor's
    ``Shard`` splits a dim (``torch.chunk``'s pieces, empty at the end:
    60 over 16 is fifteen 4s and a 0)."""
    size = -(-E // m)
    return [max(0, min(size, E - i * size)) for i in range(m)]


def _all_to_all(x: torch.Tensor, out_splits: list[int],
                in_splits: list[int], group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_to_all_single(
        x.contiguous(), out_splits, in_splits, group))


class _ToExperts(torch.autograd.Function):
    """An expert weight from its width over 'model' to its experts over
    'model', by one all-to-all: this rank's (E, ..., F/m, ...) slice (the
    width at dim ``fdim``) in, its ``counts[r]`` experts at full width
    (n, ..., F, ...) out.  The backward is the transposed all-to-all."""

    @staticmethod
    def forward(ctx, w, fdim: int, counts: list[int], r: int, group):
        ctx.args = fdim, counts, r, group
        m, n = len(counts), counts[r]
        got = _all_to_all(w, [n] * m, counts, group)     # (m·n, ..., F/m)
        got = got.view(m, n, *w.shape[1:]).movedim(0, fdim)
        return got.flatten(fdim, fdim + 1)

    @staticmethod
    def backward(ctx, g):
        fdim, counts, r, group = ctx.args
        m, n = len(counts), counts[r]
        # the width's split written out: a rank of no experts has g empty
        g = g.unflatten(fdim, (m, g.shape[fdim] // m)).movedim(fdim, 0) \
            .flatten(0, 1)
        return _all_to_all(g, counts, [n] * m, group), None, None, None, None


def _sharded_moe(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                 with_aux: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``moe_forward`` on DTensors: x (B, S, D) sharded on batch and
    replicated over 'model', the router replicated, the expert weights'
    width F over 'model' (``param_specs``).  Through ``local_map``, each
    rank routes and dispatches its own rows to every expert, takes the
    buffers of its experts (``expert_split``), brings their weights to
    full width (``_ToExperts``), runs them and combines their outputs;
    the partial sums, with the shared expert's, are all-reduced over
    'model' to x's placements.  Gradients come back partial where the
    forward's sums were: x's and the router's over 'model', the experts'
    over the batch dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    e = cfg.moe
    if e.impl != "ep":
        raise NotImplementedError(f"the sharded MoE runs impl='ep', not "
                                  f"{e.impl!r}")
    mesh = x.device_mesh
    md = mesh.mesh_dim_names.index("model")
    E, C, k = e.num_experts, capacity(cfg, x.shape[1]), e.top_k
    xp = x.placements
    fdims = {"w_gate": 2, "w_up": 2, "w_down": 1}
    for name, fd in fdims.items():
        pl = p[name].placements
        if pl[md] != Shard(fd) or any(not q.is_replicate()
                                      for i, q in enumerate(pl) if i != md):
            raise ValueError(f"expert weight {name} placed {pl}: the sharded "
                             f"MoE takes its width F over 'model' alone")
    if xp[md] != Replicate() or any(q.is_partial() or
                                    (q.is_shard() and q.dim != 0)
                                    for q in xp):
        raise ValueError(f"the sharded MoE takes x sharded on batch and "
                         f"replicated over 'model', not {xp}")
    counts = expert_split(E, mesh.size(md))
    r = mesh.get_local_rank(md)
    first, group = sum(counts[:r]), mesh.get_group(md)

    logits = (x @ p["router"]).float()                    # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    # laid out as x (a batch of one row may come out of the product
    # replicated over a mesh dim of one rank)
    rows = probs if probs.placements == xp else probs.redistribute(mesh, xp)

    def local(xl, pl_, wg, wu, wd):
        w, idx = _route(pl_, k)
        buf, rank = _dispatch(xl, idx, C, E)
        buf = buf[first:first + counts[r]]
        g = torch.bmm(buf, _ToExperts.apply(wg, 2, counts, r, group))
        u = torch.bmm(buf, _ToExperts.apply(wu, 2, counts, r, group))
        del buf
        h = F.silu(g).mul_(u)
        del g, u
        out = torch.bmm(h, _ToExperts.apply(wd, 1, counts, r, group))
        return _combine(out, w, idx, rank, C, first)

    partial = tuple(Partial() if i == md else q for i, q in enumerate(xp))
    by_batch = tuple(Partial() if q.is_shard() else Replicate() for q in xp)
    wpl = [p[n].placements for n in fdims]
    wgrad = [tuple(q if i == md else by_batch[i] for i, q in enumerate(pl))
             for pl in wpl]
    y = local_map(local, out_placements=(partial,),
                  in_placements=(xp, xp, *wpl),
                  in_grad_placements=(partial, partial, *wgrad),
                  device_mesh=mesh)(x, rows, p["w_gate"], p["w_up"],
                                    p["w_down"])
    aux = _aux_loss(logits, probs, E) if with_aux else None
    if "shared" in p:           # partial over 'model' too: one all-reduce
        sp = p["shared"]
        y = y + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.redistribute(mesh, xp).to(x.dtype), aux


def _aux_loss(logits: torch.Tensor, probs: torch.Tensor,
              E: int) -> torch.Tensor:
    """The Switch-style load-balance loss E * sum_e f_e * p_e over the
    whole batch: f_e the share of tokens whose top expert is e, p_e the
    mean probability of e.  On DTensors sharded on batch the two sums
    come together by one all-reduce."""
    n = logits.shape[0] * logits.shape[1]
    top1 = logits.argmax(dim=-1)[..., None]
    sums = torch.stack([
        (top1 == torch.arange(E, device=logits.device)).float().sum(
            dim=(0, 1)),
        probs.sum(dim=(0, 1))])
    if is_dtensor(sums):
        from torch.distributed.tensor import Replicate
        sums = sums.redistribute(sums.device_mesh,
                                 [Replicate()] * sums.device_mesh.ndim)
    f, pbar = sums / n
    return E * torch.sum(f * pbar)


def moe_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                with_aux: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x: (B, S, D) -> (y (B, S, D) in x's type, the Switch-style
    load-balance aux loss, an f32 scalar, or None without ``with_aux``:
    serving has no use for it).  DTensors go through ``_sharded_moe``."""
    if is_dtensor(x):
        return _sharded_moe(p, cfg, x, with_aux=with_aux)
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
    aux = _aux_loss(logits, probs, E) if with_aux else None

    if "shared" in p:
        sp = p["shared"]
        y = y + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.to(x.dtype), aux
