"""Public model API for training and serving: the port of
``repro/models/model.py``."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..device import generator as make_generator
from ..device import resolve_device
from ..parallel.sharding import is_dtensor, plain_as_replicated
from .lm import (
    NO_REMAT, RematPolicy, check_supported, init_cache, init_lm, lm_forward,
    run_encoder,
)


class CrossEntropy(torch.autograd.Function):
    """Mean token cross-entropy in f32 math over logits kept in their own
    type, the reference's ``custom_vjp``.  It saves the logits as they
    are with their row max ``m`` and ``sumexp``, never an f32 copy of the
    (tokens x vocab) tensor, and its backward gives (g / n_tokens) ·
    (softmax - onehot) cast to the logits' type.

    Vocab-parallel (Megatron's) where ``group`` is given: the logits are
    this rank's vocab slice from ``vocab_start``, the row max, the
    ``sumexp`` and each token's own logit are all-reduced over ``group``
    (max, sum, sum: three (tokens,) all-reduces, never the logits), and
    the result is this rank's tokens' sum over ``n_tokens``, the whole
    batch's count.  The backward needs no collective."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor,
                n_tokens: Optional[int] = None, vocab_start: int = 0,
                group=None):
        labels = labels.long()
        lf = logits.float()
        m = _reduce(lf.amax(dim=-1, keepdim=True), "max", group)
        sumexp = _reduce((lf - m).exp_().sum(dim=-1), "sum", group)
        lse = m[..., 0] + torch.log(sumexp)
        own = labels - vocab_start
        if group is None:
            ll = lf.gather(-1, own[..., None])[..., 0]
        else:
            inside = (own >= 0) & (own < lf.shape[-1])
            own = torch.where(inside, own, torch.zeros_like(own))
            ll = lf.gather(-1, own[..., None])[..., 0]
            ll = _reduce(torch.where(inside, ll, torch.zeros_like(ll)), "sum",
                         group)
            own = torch.where(inside, own, torch.full_like(own, -1))
        del lf
        ctx.n = labels.numel() if n_tokens is None else n_tokens
        ctx.save_for_backward(logits, own, m[..., 0], sumexp)
        return (lse - ll).sum() / ctx.n

    @staticmethod
    def backward(ctx, g):
        logits, own, m, sumexp = ctx.saved_tensors
        # in place: one f32 (tokens x vocab) tensor at a time
        d = logits.float().sub_(m[..., None]).exp_().div_(sumexp[..., None])
        idx = own[..., None].clamp(min=0)
        hit = (own >= 0)[..., None]              # the label is in this slice
        d.scatter_(-1, idx, torch.where(hit, d.gather(-1, idx) - 1.0,
                                        d.gather(-1, idx)))   # p - onehot
        return ((g / ctx.n) * d).to(logits.dtype), None, None, None, None


def _reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    if group is None:
        return t
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def _sharded_cross_entropy(logits, labels) -> torch.Tensor:
    """``CrossEntropy`` on DTensor logits (B, S, V) sharded on batch and,
    where it divides, vocab, through ``local_map``: vocab-parallel over
    the mesh dim that shards the vocab, each rank's token sum a partial
    sum over the batch dims, brought together by one scalar all-reduce."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    vocab = [i for i, p in enumerate(logits.placements) if p.is_shard(2)]
    if len(vocab) > 1 or any(p.is_partial() or (p.is_shard() and p.dim not in
                                                (0, 2))
                             for p in logits.placements):
        raise ValueError(f"sharded cross-entropy takes logits sharded on "
                         f"batch and vocab, not {logits.placements}")
    group, start = None, 0
    if vocab and mesh.size(vocab[0]) > 1:
        group = mesh.get_group(vocab[0])
        start = mesh.get_local_rank(vocab[0]) * \
            (logits.shape[2] // mesh.size(vocab[0]))
    n = labels.numel()
    out = [Partial() if p.is_shard(0) else Replicate()
           for p in logits.placements]

    def local(lg, lb):
        return CrossEntropy.apply(lg, lb, n, start, group)

    loss = local_map(local, out_placements=(tuple(out),),
                     in_placements=(logits.placements, labels.placements),
                     device_mesh=mesh)(logits, labels)
    return loss.redistribute(mesh, [Replicate()] * mesh.ndim)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) in the working type, labels (B, S) integer ->
    the mean token cross-entropy, an f32 scalar (on DTensors: replicated,
    see ``_sharded_cross_entropy``)."""
    if is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels)
    return CrossEntropy.apply(logits, labels)


@dataclasses.dataclass(frozen=True)
class Model:
    """``device=None`` runs on the CUDA card and raises on a host without
    one; ``device="cpu"`` runs on the host.  ``remat`` checkpoints
    training's forward (``loss``); ``moe_aux_weight`` weighs a MoE's
    load-balance loss into it."""

    cfg: ArchConfig
    device: Optional[torch.device] = None
    remat: RematPolicy = RematPolicy()
    moe_aux_weight: float = 0.01
    # sharding hooks, read on DTensor parameters (``lm_forward``): FSDP's
    # per-layer unshard (one layer's tree of specs), the residual
    # stream's spec, and the collective trace's layer boundaries
    layer_specs: object = None
    act_spec: object = None
    layer_mark: Optional[Callable] = None

    def __post_init__(self):
        check_supported(self.cfg)
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- parameters --------------------------------------------------------
    def init(self, seed: int) -> dict:
        """Random weights drawn on this model's device from ``seed``."""
        return init_lm(self.cfg, make_generator(seed, self.device))

    # -- training ----------------------------------------------------------
    def loss(self, params: dict, batch: dict
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(loss, {"ce", "moe_aux"}) over ``batch`` (its ``labels`` (B,
        S) beside the forward's keys), differentiable in ``params``: the
        token cross-entropy plus ``moe_aux_weight`` times the summed MoE
        aux loss."""
        with plain_as_replicated(params):
            logits, _, aux = lm_forward(params, self.cfg, batch,
                                        remat=self.remat, with_aux=True,
                                        **self._hooks())
            ce = cross_entropy(logits, batch["labels"])
            return ce + self.moe_aux_weight * aux, {"ce": ce, "moe_aux": aux}

    def _hooks(self) -> dict:
        return dict(layer_specs=self.layer_specs, act_spec=self.act_spec,
                    layer_mark=self.layer_mark)

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, *,
                last_only: bool = False) -> torch.Tensor:
        """Full-sequence forward: logits (B, S, V), or (B, 1, V) with
        last_only (serving needs only the next-token distribution)."""
        with plain_as_replicated(params):
            logits, _, _ = lm_forward(params, self.cfg, batch,
                                      last_only=last_only, **self._hooks())
        return logits

    @torch.no_grad()
    def encode(self, params: dict, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder-decoder's encoder over frame embeddings (B, Se, D):
        the memory that ``batch["enc_memory"]`` hands to the decoder, so
        that prefill and each decode step skip the encoder."""
        if self.cfg.family != "encdec":
            raise ValueError(f"{self.cfg.name} has no encoder")
        return run_encoder(params, self.cfg, enc_embeds, NO_REMAT)

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
        logits, caches, _ = lm_forward(
            params, self.cfg, batch, caches=caches, cache_index=cache_index,
            window_override=win or 0)
        return logits, caches

    # -- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, self.device)
