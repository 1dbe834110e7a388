"""The LM: the port of ``repro/models/lm.py`` for every family — dense,
MoE (uniform, or DeepSeek-V2's MLA with a dense first layer), the VLM
backbone (M-RoPE), Mamba-2, the encoder-decoder and the Jamba hybrid.

Parameters are plain nested dicts of tensors in the reference's (in,
out) layout, so ``x @ w`` is the reference's einsum.  Where the reference
stacks layers on a leading L axis and scans them, the port keeps one dict
per layer in a list and loops in Python; the encoder-decoder keeps its
encoder and decoder layers in two lists (``encoder``, ``layers``), and a
config with ``first_dense_layers`` its unrolled first layer apart
(``layer0``).  The hybrid keeps one dict per period in ``periods``,
each with its own lists of sublayers as the reference stacks them:
``mamba`` (period - 1 of {"mixer", "ln"}), ``attn`` ({"attn", "ln"}),
``dense_ffn`` and ``moe_ffn`` (each FFN's weights and its "ln").  The
decode caches keep the reference's stacked layouts, and each layer
writes its slice in place: dense and the decoder {"k", "v"}: (L, B,
Smax, Hkv, hd); MLA {"layer0": {"latent": (B, Smax, lora + rope)},
"layers": {"latent": (L - 1, ...)}}; SSM {"conv_x", "conv_B",
"conv_C"}: (L, B, K-1, ·) in the parameter type and "state": (L, B, H,
N, hd) in f32; the hybrid, over its P periods of M = period - 1 Mamba
sublayers, {"attn": {"k", "v"}: (P, B, Smax, Hkv, hd), "mamba":
{"conv": (P, M, B, K-1, d_inner), "state": (P, M, B, d_inner, N) f32}}.

Batch keys, as in the reference: ``tokens`` (B, S), or ``embeds`` (B, S,
D) in their place; ``mrope_positions`` (3, B, S) for M-RoPE; for the
encoder-decoder ``enc_embeds`` (B, Se, D), or the encoder's output
``enc_memory`` in their place, which skips the encoder.

Training runs the same forward under autograd (``Model.loss``): without
caches the layers go through ``run_layers_remat``, which checkpoints
them as the reference's ``scan_layers_remat`` does (``RematPolicy``),
and a MoE's load-balance aux loss is summed over its layers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig
from .attention import (
    cache_mask, cross_forward, gqa_forward, init_cross, init_gqa, init_mla,
    mla_forward, rotary_tables,
)
from .common import InitCtx, gelu_mlp, layer_norm, rms_norm, swiglu
from .moe import init_moe, moe_forward
from .ssm import (
    init_mamba1, init_mamba2, mamba1_cache_spec, mamba1_forward,
    mamba2_cache_spec, mamba2_forward,
)


def check_supported(cfg: ArchConfig) -> None:
    """The port runs decoder-only GQA LMs with RoPE (family 'dense', with
    or without q/k/v biases, tied or untied embeddings), their MoE
    variant (family 'moe': a routed MoE on every layer, or with MLA one
    dense first layer and the MoE on the rest), the VLM backbone (family
    'vlm', M-RoPE over three position streams), Mamba-2 (SSD) LMs with an
    untied lm_head, the encoder-decoder (family 'encdec') and the Jamba
    hybrid (family 'hybrid': periods of Mamba-1 sublayers and one GQA
    sublayer, each followed by a SwiGLU or, on every second sublayer, a
    MoE), the only hybrid the reference's period computes as its config
    says."""
    if cfg.family == "hybrid":
        _check_hybrid(cfg)
        return
    if cfg.family == "ssm":
        if cfg.ssm is None or cfg.ssm.variant != "ssd" or cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: the port runs SSM LMs of the Mamba-2 (ssd) "
                f"variant with an untied lm_head")
        return
    if cfg.family not in ("dense", "moe", "vlm", "encdec") or cfg.hybrid:
        raise NotImplementedError(
            f"{cfg.name}: the port runs families dense, moe, vlm, ssm, "
            f"encdec and hybrid; not family {cfg.family!r} with hybrid "
            f"{cfg.hybrid}")
    if (cfg.family == "moe") != (cfg.moe is not None):
        raise NotImplementedError(
            f"{cfg.name}: the port runs family 'moe' with a routed MoE, and "
            f"no other family with one")
    if cfg.moe and cfg.moe.every_k_layers != 1:
        raise NotImplementedError(
            f"{cfg.name}: the port runs a MoE on every layer, not every "
            f"{cfg.moe.every_k_layers}")
    if cfg.mla and not cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: the port runs MLA on a MoE config (DeepSeek-V2), "
            f"not on family {cfg.family!r}")
    if cfg.moe and cfg.moe.first_dense_layers not in (0, 1):
        raise NotImplementedError(
            f"{cfg.name}: the port unrolls one dense first layer, as the "
            f"reference does, not {cfg.moe.first_dense_layers}")
    if (cfg.family == "encdec") != (cfg.encdec is not None):
        raise NotImplementedError(
            f"{cfg.name}: family 'encdec' needs an EncDecConfig, and no "
            f"other family takes one")
    if cfg.mrope_sections and sum(cfg.mrope_sections) != cfg.hd // 2:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE sections {cfg.mrope_sections} must sum to "
            f"head_dim / 2 = {cfg.hd // 2}")


def _check_hybrid(cfg: ArchConfig) -> None:
    """Refuse, naming the field, a hybrid the reference's period would
    not compute as its config says: its period hard-codes Mamba-1
    sublayers, GQA attention and a MoE after every odd in-period index
    whatever ``moe.every_k_layers`` says, and floors ``num_layers /
    period``, dropping the layers past the last whole period."""
    hyb, ssm, moe = cfg.hybrid, cfg.ssm, cfg.moe
    if hyb is None or ssm is None or ssm.variant != "mamba1":
        raise NotImplementedError(
            f"{cfg.name}: the port runs the hybrid with a HybridConfig and "
            f"Mamba-1 sublayers (ssm.variant 'mamba1'), not hybrid {hyb}, "
            f"ssm {ssm}")
    if moe is None or moe.every_k_layers != 2:
        raise NotImplementedError(
            f"{cfg.name}: the hybrid's period puts a MoE after every second "
            f"sublayer; the port needs moe.every_k_layers 2, not "
            f"{None if moe is None else moe.every_k_layers}")
    if cfg.num_layers % hyb.period:
        raise NotImplementedError(
            f"{cfg.name}: num_layers {cfg.num_layers} is not a multiple of "
            f"hybrid.period {hyb.period}; the reference would drop the "
            f"last {cfg.num_layers % hyb.period}")
    if not 0 <= hyb.attn_index < hyb.period or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: the hybrid's GQA sublayer must sit inside the "
            f"period (hybrid.attn_index {hyb.attn_index} of "
            f"{hyb.period}), and it takes no MLA")


def _first_dense(cfg: ArchConfig) -> int:
    return cfg.moe.first_dense_layers if cfg.moe else 0


def _dense_layer_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    D = cfg.d_model
    p = {
        "ln1": ctx.make((D,), scale="embed"),
        "ln2": ctx.make((D,), scale="embed"),
        "attn": init_mla(ctx, cfg) if cfg.mla else init_gqa(ctx, cfg),
    }
    p["mlp"] = init_moe(ctx, cfg) if cfg.moe else _swiglu_params(ctx, cfg)
    return p


def _swiglu_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"w_gate": ctx.make((D, F)), "w_up": ctx.make((D, F)),
            "w_down": ctx.make((F, D))}


def _dense_layer(p: dict, cfg: ArchConfig, x: torch.Tensor, *, positions,
                 rope, mrope_positions=None, mask=None, cache=None,
                 cache_index=None, window=0, with_aux=False
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x', the MoE's aux loss where ``with_aux`` and the layer has a
    MoE, else None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        attn_out, _ = mla_forward(p["attn"], cfg, h, positions=positions,
                                  cache=cache, cache_index=cache_index,
                                  rope=rope, mask=mask)
    else:
        attn_out, _ = gqa_forward(p["attn"], cfg, h, positions=positions,
                                  window=window,
                                  mrope_positions=mrope_positions,
                                  cache=cache, cache_index=cache_index,
                                  rope=rope, mask=mask)
    x = x + attn_out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    if cfg.moe:                 # the aux loss feeds only training's loss
        y, aux = moe_forward(m, cfg, h, with_aux=with_aux)
        return x + y, aux
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"]), None


def _ssm_layer_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    return {"mixer": init_mamba2(ctx, cfg),
            "ln1": ctx.make((cfg.d_model,), scale="embed")}


def _ssm_layer(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
               cache=None) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, _ = mamba2_forward(p["mixer"], cfg, h, cache=cache)
    return x + out


def _jamba_period_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    """One period: ``period - 1`` Mamba-1 sublayers and one GQA sublayer,
    each behind its own RMS norm, and after each sublayer an FFN behind
    its own norm: ``period // 2`` MoEs (odd in-period indices) and the
    rest SwiGLUs (even ones)."""
    per = cfg.hybrid.period

    def norm():
        return ctx.make((cfg.d_model,), scale="embed")

    return {
        "mamba": [{"mixer": init_mamba1(ctx, cfg), "ln": norm()}
                  for _ in range(per - 1)],
        "attn": {"attn": init_gqa(ctx, cfg), "ln": norm()},
        "dense_ffn": [{**_swiglu_params(ctx, cfg), "ln": norm()}
                      for _ in range(per - per // 2)],
        "moe_ffn": [{**init_moe(ctx, cfg), "ln": norm()}
                    for _ in range(per // 2)],
    }


def _jamba_period(p: dict, cfg: ArchConfig, x: torch.Tensor, *, caches,
                  period: int, positions, rope, mask, cache_index,
                  window, with_aux=False
                  ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reference's ``_jamba_period``: sublayer ``attn_index`` is GQA
    attention (windowed by ``window``), the others Mamba-1 in order; an
    FFN follows each, the MoE after odd in-period indices.  ``caches``
    (decode) is the whole stacked cache; this period's slices of it are
    written in place.  Returns (x', the period's summed MoE aux loss
    where ``with_aux``, else None)."""
    eps = cfg.norm_eps
    mi = di = ei = 0
    aux_total = None
    for sub in range(cfg.hybrid.period):
        if sub == cfg.hybrid.attn_index:
            ap = p["attn"]
            cache = None if caches is None else \
                _layer_caches(caches["attn"], period)
            out, _ = gqa_forward(ap["attn"], cfg, rms_norm(x, ap["ln"], eps),
                                 positions=positions, window=window,
                                 cache=cache, cache_index=cache_index,
                                 rope=rope, mask=mask)
        else:
            mp = p["mamba"][mi]
            cache = None if caches is None else \
                {k: c[period, mi] for k, c in caches["mamba"].items()}
            out, _ = mamba1_forward(mp["mixer"], cfg,
                                    rms_norm(x, mp["ln"], eps), cache=cache)
            mi += 1
        x = x + out
        if sub % 2 == 1:
            fp = p["moe_ffn"][ei]
            y, aux = moe_forward(fp, cfg, rms_norm(x, fp["ln"], eps),
                                 with_aux=with_aux)
            x = x + y
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
            ei += 1
        else:
            fp = p["dense_ffn"][di]
            x = x + swiglu(rms_norm(x, fp["ln"], eps), fp["w_gate"],
                           fp["w_up"], fp["w_down"])
            di += 1
    return x, aux_total


def _gelu_mlp_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"w_in": ctx.make((D, F)), "b_in": ctx.make((F,), zero=True),
            "w_out": ctx.make((F, D)), "b_out": ctx.make((D,), zero=True)}


def _norm_params(ctx: InitCtx, cfg: ArchConfig, *names: str) -> dict:
    """A layer norm's scale (ones-scale draw) and bias (zero) per name."""
    D = cfg.d_model
    out = {}
    for n in names:
        out[n] = ctx.make((D,), scale="embed")
        out[n + "b"] = ctx.make((D,), zero=True)
    return out


def _encoder_layer_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    return {"attn": init_gqa(ctx, cfg), "mlp": _gelu_mlp_params(ctx, cfg),
            **_norm_params(ctx, cfg, "ln1", "ln2")}


def _decoder_layer_params(ctx: InitCtx, cfg: ArchConfig) -> dict:
    return {"attn": init_gqa(ctx, cfg), "cross": init_cross(ctx, cfg),
            "mlp": _gelu_mlp_params(ctx, cfg),
            **_norm_params(ctx, cfg, "ln1", "lnx", "ln2")}


def _mlp(p: dict, h: torch.Tensor) -> torch.Tensor:
    return gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def _save_2d_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective checkpointing's policy for ``dots_with_no_batch_dims_
    saveable``: keep the outputs of products without a batch dimension
    (``x @ w`` of a projection lowers to ``aten.mm``), recompute the rest
    (the attention's batched ``bmm`` included)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: the reference's ``jax.checkpoint_policies`` the port takes, each as
#: ``torch.utils.checkpoint`` keywords
REMAT_POLICIES = {
    "nothing_saveable": {},
    "dots_with_no_batch_dims_saveable": {
        "context_fn": functools.partial(create_selective_checkpoint_contexts,
                                        _save_2d_products)},
}


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """Activation recomputation for training, the reference's
    ``RematPolicy`` on ``torch.utils.checkpoint`` (non-reentrant).

    ``nothing_saveable`` keeps only each checkpointed block's input and
    recomputes the block in the backward; ``dots_with_no_batch_dims_
    saveable`` keeps the 2-D products' outputs as well.  ``scan_group``
    is the reference's sqrt remat: groups of G layers, each group and
    each layer in it checkpointed, so about L / G + G block inputs live
    at once instead of L; 0 picks the largest divisor of L at most √L, 1
    checkpoints each layer alone."""

    enabled: bool = True
    policy: str = "nothing_saveable"
    scan_group: int = 0

    def __post_init__(self):
        if self.policy not in REMAT_POLICIES:
            raise ValueError(f"remat policy {self.policy!r}: the port takes "
                             f"{sorted(REMAT_POLICIES)}")

    def wrap(self, fn: Callable) -> Callable:
        if not self.enabled:
            return fn
        kw = REMAT_POLICIES[self.policy]

        def run(*args):
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return run

    def group_for(self, L: int) -> int:
        if not self.enabled:
            return 1
        if self.scan_group:
            return self.scan_group if L % self.scan_group == 0 else 1
        g = math.isqrt(L)
        while g > 1 and L % g:
            g -= 1
        return g


#: serving's forward: no checkpoint
NO_REMAT = RematPolicy(enabled=False)


def run_layers_remat(block: Callable, x: torch.Tensor, layers: list,
                     remat: RematPolicy
                     ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The reference's ``scan_layers_remat`` over the port's list of
    layers: ``block(x, layer) -> (x, aux | None)`` run in order, each
    call checkpointed by ``remat``, and with ``remat.group_for(L)`` G > 1
    each run of G layers checkpointed as one block too.  Returns (x, the
    blocks' aux losses that are not None, in layer order)."""
    one = remat.wrap(block)

    def run(x, group):
        auxs = []
        for lp in group:
            x, aux = one(x, lp)
            if aux is not None:
                auxs.append(aux)
        return x, auxs

    G = remat.group_for(len(layers))
    if G <= 1:
        return run(x, layers)
    grouped = remat.wrap(run)
    auxs = []
    for g0 in range(0, len(layers), G):
        x, a = grouped(x, layers[g0:g0 + G])
        auxs += a
    return x, auxs


def init_lm(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random weights at the reference's scales, drawn on the
    generator's device, in the reference's tree."""
    check_supported(cfg)
    ctx = InitCtx(generator=generator, dtype=cfg.param_dtype())
    params = {
        "embed": ctx.make((cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": ctx.make((cfg.d_model,), scale="embed"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ctx.make((cfg.d_model, cfg.vocab))
    if cfg.family == "ssm":
        params["layers"] = [_ssm_layer_params(ctx, cfg)
                            for _ in range(cfg.num_layers)]
    elif cfg.family == "hybrid":
        params["periods"] = [_jamba_period_params(ctx, cfg)
                             for _ in range(_n_periods(cfg))]
    elif cfg.family == "encdec":
        params["encoder"] = [_encoder_layer_params(ctx, cfg)
                             for _ in range(cfg.encdec.num_encoder_layers)]
        params["layers"] = [_decoder_layer_params(ctx, cfg)
                            for _ in range(cfg.num_layers)]
        params["enc_final_norm_b"] = ctx.make((cfg.d_model,), zero=True)
        params["final_norm_b"] = ctx.make((cfg.d_model,), zero=True)
    else:
        first = _first_dense(cfg)
        if first:
            params["layer0"] = _dense_layer_params(
                ctx, dataclasses.replace(cfg, moe=None))
        params["layers"] = [_dense_layer_params(ctx, cfg)
                            for _ in range(cfg.num_layers - first)]
    return params


def _embed(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    if "embeds" in batch:
        return batch["embeds"].to(cfg.param_dtype())
    return params["embed"][batch["tokens"]]


def _unembed(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def run_encoder(params: dict, cfg: ArchConfig, enc_embeds: torch.Tensor,
                remat: RematPolicy = NO_REMAT) -> torch.Tensor:
    """The encoder over frame embeddings (B, Se, D): non-causal
    self-attention and the GELU MLP, pre-LN, its layers checkpointed by
    ``remat``.  Its final norm borrows the decoder's ``final_norm`` scale
    with its own bias ``enc_final_norm_b``, as the reference's does."""
    x = enc_embeds.to(cfg.param_dtype())
    positions = torch.arange(x.shape[1], device=x.device)
    rope = rotary_tables(cfg, positions, None, cfg.hd)

    def block(x, lp):
        h = layer_norm(x, lp["ln1"], lp["ln1b"], cfg.norm_eps)
        out, _ = gqa_forward(lp["attn"], cfg, h, positions=positions,
                             causal=False, rope=rope)
        x = x + out
        h = layer_norm(x, lp["ln2"], lp["ln2b"], cfg.norm_eps)
        return x + _mlp(lp["mlp"], h), None

    x, _ = run_layers_remat(block, x, params["encoder"], remat)
    return layer_norm(x, params["final_norm"], params["enc_final_norm_b"],
                      cfg.norm_eps)


def _decoder_layer(lp: dict, cfg: ArchConfig, x: torch.Tensor, memory, *,
                   positions, rope, mask, cache, cache_index) -> torch.Tensor:
    h = layer_norm(x, lp["ln1"], lp["ln1b"], cfg.norm_eps)
    out, _ = gqa_forward(lp["attn"], cfg, h, positions=positions,
                         cache=cache, cache_index=cache_index, rope=rope,
                         mask=mask)
    x = x + out
    h = layer_norm(x, lp["lnx"], lp["lnxb"], cfg.norm_eps)
    x = x + cross_forward(lp["cross"], cfg, h, memory)
    h = layer_norm(x, lp["ln2"], lp["ln2b"], cfg.norm_eps)
    return x + _mlp(lp["mlp"], h)


def _layer_caches(caches: dict, i: int) -> dict:
    return {k: c[i] for k, c in caches.items()}


def _cache_of(caches: Optional[dict], i: Optional[int]) -> Optional[dict]:
    """Layer ``i``'s slices of stacked caches, or None without caches."""
    return None if caches is None else _layer_caches(caches, i)


def lm_forward(
    params: dict, cfg: ArchConfig, batch: dict, *,
    remat: RematPolicy = NO_REMAT,
    caches: Optional[dict] = None,
    cache_index: Optional[int] = None,
    window_override: Optional[int] = None,
    last_only: bool = False,
    with_aux: bool = False,
) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (logits (B, S, V), caches | None, the MoE aux loss summed
    over the layers: an f32 scalar, 0 without a MoE or ``with_aux``); the
    caches are updated in place.  last_only: unembed only the final
    position.  ``remat`` checkpoints the layers of a forward without
    caches (training's; serving passes none)."""
    x = _embed(params, cfg, batch)
    S = x.shape[1]
    start = 0 if cache_index is None else cache_index
    positions = start + torch.arange(S, device=x.device)
    # MLA and the encoder-decoder's self-attention take no window, as in
    # the reference
    window = 0 if cfg.mla or cfg.encdec else (window_override or 0)
    rope = mask = None
    if cfg.family != "ssm":     # the same for every layer: made once
        rope = rotary_tables(cfg, positions, batch.get("mrope_positions"),
                             cfg.mla.qk_rope_dim if cfg.mla else cfg.hd)
        if caches is not None:
            mask = cache_mask(start, S, _cache_len(cfg, caches), window,
                              x.device)
    kw = dict(positions=positions, rope=rope, mask=mask,
              cache_index=cache_index)
    # block(x, layer, i) -> (x, aux | None); i picks the layer's slice of
    # the caches (None without caches)
    if cfg.family == "ssm":                      # cache_index plays no part
        layers = params["layers"]

        def block(x, lp, i):
            return _ssm_layer(lp, cfg, x, cache=_cache_of(caches, i)), None
    elif cfg.family == "hybrid":
        layers = params["periods"]

        def block(x, pp, i):
            return _jamba_period(pp, cfg, x, caches=caches, period=i,
                                 window=window, with_aux=with_aux, **kw)
    elif cfg.family == "encdec":
        memory = batch.get("enc_memory")
        if memory is None:
            memory = run_encoder(params, cfg, batch["enc_embeds"], remat)
        layers = params["layers"]

        def block(x, lp, i):
            return _decoder_layer(lp, cfg, x, memory,
                                  cache=_cache_of(caches, i), **kw), None
    else:
        kw.update(mrope_positions=batch.get("mrope_positions"), window=window)
        stack = caches
        if _first_dense(cfg):       # unrolled, outside the remat, as there
            x, _ = _dense_layer(params["layer0"],
                                dataclasses.replace(cfg, moe=None), x,
                                cache=None if caches is None
                                else caches["layer0"], **kw)
            stack = None if caches is None else caches["layers"]
        layers = params["layers"]

        def block(x, lp, i):
            return _dense_layer(lp, cfg, x, cache=_cache_of(stack, i),
                                with_aux=with_aux, **kw)
    auxs: list[torch.Tensor] = []
    if remat.enabled and caches is None:
        x, auxs = run_layers_remat(lambda x, lp: block(x, lp, None), x,
                                   layers, remat)
    else:       # in this frame, so that no layer's input outlives it
        for i, lp in enumerate(layers):
            x, aux = block(x, lp, i)
            if aux is not None:
                auxs.append(aux)
    if last_only:
        x = x[:, -1:, :]
    if cfg.family == "encdec":
        x = layer_norm(x, params["final_norm"], params["final_norm_b"],
                       cfg.norm_eps)
    else:
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = (torch.stack(auxs).sum() if auxs else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return _unembed(params, cfg, x), caches, aux


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The decode cache's tree of (shape, dtype) leaves, in the
    reference's stacked layout (an SSM's does not grow with
    ``max_len``).  The encoder-decoder caches its decoder's
    self-attention only: cross-attention's K and V are projected from
    the memory on every step, as in the reference."""
    check_supported(cfg)
    dt = cfg.param_dtype()
    attn = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    if cfg.family == "ssm":
        return {k: ((cfg.num_layers, *shape), d)
                for k, (shape, d) in mamba2_cache_spec(cfg, batch).items()}
    if cfg.family == "hybrid":
        P, M = _n_periods(cfg), cfg.hybrid.period - 1
        return {"attn": {k: ((P, *attn), dt) for k in ("k", "v")},
                "mamba": {k: ((P, M, *shape), d) for k, (shape, d)
                          in mamba1_cache_spec(cfg, batch).items()}}
    if cfg.mla:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
        first = _first_dense(cfg)
        layers = {"latent": ((cfg.num_layers - first, batch, max_len, width),
                             dt)}
        if first:
            return {"layer0": {"latent": ((batch, max_len, width), dt)},
                    "layers": layers}
        return layers
    return {k: ((cfg.num_layers, *attn), dt) for k in ("k", "v")}


def _n_periods(cfg: ArchConfig) -> int:
    return cfg.num_layers // cfg.hybrid.period


def _cache_len(cfg: ArchConfig, caches: dict) -> int:
    """The slots of an attention cache (``max_len``), read from the
    config's own layout: axis 2 of every stacked attention leaf."""
    if cfg.family == "hybrid":
        stack = caches["attn"]
    else:
        stack = caches["layers"] if cfg.mla and _first_dense(cfg) else caches
    return next(iter(stack.values())).shape[2]


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    def zeros(spec):
        if isinstance(spec, dict):
            return {k: zeros(v) for k, v in spec.items()}
        shape, dt = spec
        return torch.zeros(shape, dtype=dt, device=device)
    return zeros(cache_specs(cfg, batch, max_len))
