"""Analytic per-cell FLOPs and HBM-byte model for the roofline: the
port's copy of ``repro/launch/flops.py`` (host arithmetic over
``ArchConfig``; the numbers are the reference's).

Why analytic: the reference's XLA-CPU ``cost_analysis`` counts while-loop
bodies once, and the port's traced program has no cost analysis at all,
while matmul-dominated transformer costs are exactly countable from the
config.  So the compute and memory roofline terms use this model and the
collective term the traced collectives (``launch/collectives.py``).

Conventions:
  * matmul (m,k)x(k,n): 2*m*k*n FLOPs.
  * causal attention: 0.5 * full score/PV cost.
  * train = fwd + 2x bwd + remat_fraction * fwd (nothing_saveable -> ~1).
  * bytes: weight streaming (per microbatch, per pass), optimizer
    read/write, activation traffic ~ act_rw_factor * activation bytes,
    KV-cache read for decode.
"""

from __future__ import annotations

import dataclasses
import math

from ..configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass
class CellCost:
    fwd_flops: float          # global, one forward pass
    total_flops: float        # global, whole step (train: fwd+bwd+remat)
    attn_flops: float         # part of fwd_flops
    hbm_bytes: float          # per device
    notes: dict


def _attn_flops(cfg: ArchConfig, T: float, ctx: float, *, causal: bool,
                n_layers: int | None = None) -> float:
    """Score + PV matmuls.  T queries attending to ctx keys."""
    if cfg.mla:
        qk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
        dv = cfg.mla.v_head_dim
        per = 2 * T * ctx * cfg.num_heads * (qk + dv)
    else:
        per = 2 * T * ctx * cfg.num_heads * cfg.hd * 2
    if causal and ctx == T:
        per *= 0.5
    L = n_layers if n_layers is not None else _n_attn_layers(cfg)
    return per * L


def _n_attn_layers(cfg: ArchConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid.period
    return cfg.num_layers


def _layer_proj_flops(cfg: ArchConfig, T: float) -> float:
    """Per-token matmul flops x T for all layers (no attention scores)."""
    D = cfg.d_model
    total = 0.0

    def dense_mlp(F):
        return 2 * T * D * F * 3                       # gate, up, down

    def gqa_proj():
        hd, H, Hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
        return 2 * T * D * (H * hd + 2 * Hkv * hd) + 2 * T * H * hd * D

    def mla_proj():
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        f = 2 * T * D * cfg.num_heads * qk             # q
        f += 2 * T * D * (m.kv_lora_rank + m.qk_rope_dim)   # down
        f += 2 * T * m.kv_lora_rank * cfg.num_heads * (m.qk_nope_dim + m.v_head_dim)
        f += 2 * T * cfg.num_heads * m.v_head_dim * D  # o
        return f

    def moe_ffn():
        e = cfg.moe
        f = 2 * T * D * e.num_experts                  # router
        f += 2 * T * e.top_k * e.capacity_factor * D * e.d_ff_expert * 3
        if e.num_shared:
            f += 2 * T * D * e.num_shared * e.d_ff_expert * 3
        return f

    def mamba2_proj():
        s = cfg.ssm
        di = s.expand * D
        H = di // s.head_dim
        N = s.d_state
        f = 2 * T * D * (2 * di + 2 * N + H)           # z,x,B,C,dt
        f += T * di * s.d_conv * 2
        # SSD: intra-chunk (scores 2*T*Q*N + weighted 2*T*Q*hd per head)
        Q = s.chunk
        f += 2 * T * Q * N + 2 * T * Q * di
        f += 2 * T * N * di * 2                        # state outer products + C.S
        f += 2 * T * di * D                            # out_proj
        return f

    def mamba1_proj():
        s = cfg.ssm
        di = s.expand * D
        N = s.d_state
        r = math.ceil(D / 16)
        f = 2 * T * D * 2 * di                         # x, z
        f += T * di * s.d_conv * 2
        f += 2 * T * di * (r + 2 * N)                  # x_proj
        f += 2 * T * r * di                            # dt_proj
        f += 8 * T * di * N                            # recurrence
        f += 2 * T * di * D
        return f

    if cfg.family == "ssm":
        total += cfg.num_layers * mamba2_proj()
    elif cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.hybrid.period
        n_mamba = cfg.num_layers - n_attn
        total += n_attn * gqa_proj() + n_mamba * mamba1_proj()
        n_moe = cfg.num_layers // 2          # MoE every other layer
        total += n_moe * moe_ffn() + (cfg.num_layers - n_moe) * dense_mlp(cfg.d_ff)
    elif cfg.family == "encdec":
        # decoder self + cross projections + mlp (gelu: 2 matmuls)
        hd, H = cfg.hd, cfg.num_heads
        dec = 2 * T * D * 3 * H * hd + 2 * T * H * hd * D      # self qkv+o
        dec += 2 * T * D * H * hd + 2 * T * H * hd * D         # cross q+o
        dec += 2 * T * D * cfg.d_ff * 2
        total += cfg.num_layers * dec
    elif cfg.mla:
        e = cfg.moe
        total += cfg.num_layers * mla_proj()
        total += e.first_dense_layers * dense_mlp(cfg.d_ff)
        total += (cfg.num_layers - e.first_dense_layers) * moe_ffn()
    elif cfg.moe:
        total += cfg.num_layers * (gqa_proj() + moe_ffn())
    else:
        total += cfg.num_layers * (gqa_proj() + dense_mlp(cfg.d_ff))
    return total


def _encoder_flops(cfg: ArchConfig, B: float) -> float:
    if not cfg.encdec:
        return 0.0
    ec = cfg.encdec
    Te = B * ec.encoder_seq
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    per = 2 * Te * D * 3 * H * hd + 2 * Te * H * hd * D
    per += 2 * Te * D * cfg.d_ff * 2
    per += 2 * Te * ec.encoder_seq * H * hd * 2          # full bidir attn
    return per * ec.num_encoder_layers


def _cross_kv_flops(cfg: ArchConfig, B: float, T: float) -> float:
    if not cfg.encdec:
        return 0.0
    ec = cfg.encdec
    Te = B * ec.encoder_seq
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    kv = 2 * Te * D * 2 * H * hd * cfg.num_layers        # k,v from memory
    scores = 2 * T * ec.encoder_seq * H * hd * 2 * cfg.num_layers
    return kv + scores


def cell_cost(
    cfg: ArchConfig, shape: ShapeConfig, *,
    n_params: int, n_chips: int, model_shards: int, data_shards: int,
    grad_accum: int = 1, fsdp: bool = False,
    opt_bytes_per_param: int = 8, remat_fraction: float = 1.0,
    act_rw_factor: float = 8.0,
) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    T = B * (1 if kind == "decode" else S)
    ctx = S if kind == "decode" else S

    proj = _layer_proj_flops(cfg, T)
    if kind == "decode":
        attn = _attn_flops(cfg, T, ctx, causal=False)
        if cfg.sliding_window and shape.seq_len > cfg.sliding_window:
            attn = _attn_flops(cfg, T, cfg.sliding_window, causal=False)
    else:
        attn = _attn_flops(cfg, T, S, causal=True)
    enc = _encoder_flops(cfg, B) if kind != "decode" else 0.0
    cross = _cross_kv_flops(cfg, B, T) if cfg.encdec else 0.0
    if kind == "decode" and cfg.encdec:
        cross = _cross_kv_flops(cfg, B, T)               # cross kv recomputed
    unembed = 2 * T * cfg.d_model * cfg.vocab
    if kind == "prefill":
        unembed = 2 * B * cfg.d_model * cfg.vocab        # last position only
    fwd = proj + attn + enc + cross + unembed

    if kind == "train":
        total = fwd * (3.0 + remat_fraction)
    else:
        total = fwd

    # ---- bytes (per device) ----
    w_local = n_params * 2 / model_shards                # gathered TP shard
    w_resident = n_params * 2 / (model_shards * (data_shards if fsdp else 1))
    if kind == "train":
        passes = 3 + remat_fraction                      # fwd, remat, dgrad, wgrad
        weight_bytes = grad_accum * passes * w_local
        opt_bytes = (n_params / (model_shards * (data_shards if fsdp else 1))) \
            * (opt_bytes_per_param + 2 * 2 + 4 * 2)      # m,v rw + p rw + g
        act_local = (T / (n_chips / model_shards)) * cfg.d_model * 2 \
            * cfg.num_layers
        act_bytes = act_rw_factor * act_local
        hbm = weight_bytes + opt_bytes + act_bytes
    elif kind == "prefill":
        act_local = (T / (n_chips / model_shards)) * cfg.d_model * 2 \
            * cfg.num_layers
        hbm = w_local + act_rw_factor * act_local
    else:  # decode: weights + cache read once per token
        cache_bytes = _cache_bytes(cfg, B, S) / n_chips
        hbm = w_local + cache_bytes
    return CellCost(
        fwd_flops=fwd, total_flops=total, attn_flops=attn + cross,
        hbm_bytes=hbm,
        notes={"w_local": w_local, "w_resident": w_resident,
               "remat_fraction": remat_fraction},
    )


def resident_bytes(
    cfg: ArchConfig, shape: ShapeConfig, *,
    n_params: int, n_chips: int, model_shards: int,
    grad_accum: int = 1, fsdp: bool = False, opt_bytes_per_param: int = 8,
) -> dict:
    """Analytic per-device HBM residency (bf16 matmuls run native, no f32
    conversion copies): the number the dry run holds against the card's
    memory (``mesh.DEVICE_MEMORY``)."""
    data_shards = n_chips // model_shards
    pshard = model_shards * (data_shards if fsdp else 1)
    out = {"params": n_params * 2 / pshard}
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out["opt_state"] = n_params * opt_bytes_per_param / pshard
        out["grads_accum"] = n_params * 4 / pshard
        L = cfg.num_layers
        g = int(math.isqrt(L)) or 1
        while g > 1 and L % g:
            g -= 1
        saved = (L // g + g)
        b_micro = max(1, B // grad_accum // data_shards)
        out["saved_activations"] = saved * b_micro * S * cfg.d_model * 2
        if fsdp:
            # transient gathered weights for ~2 layers (double buffered)
            out["fsdp_gather"] = 2 * (n_params / cfg.num_layers) * 2 / model_shards
        v_local = cfg.vocab / (model_shards if cfg.vocab % model_shards == 0 else 1)
        out["logits_micro"] = b_micro * S * v_local * 2 * 2
    elif shape.kind == "prefill":
        b_local = max(1, B // data_shards)
        out["activations"] = 4 * b_local * S * cfg.d_model * 2
    else:
        out["kv_cache"] = _cache_bytes(cfg, B, S) / n_chips
    out["total"] = sum(out.values())
    return out


def _cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        H = di // s.head_dim
        return cfg.num_layers * B * (H * s.d_state * s.head_dim * 4
                                     + (s.d_conv - 1) * (di + 2 * s.d_state) * 2)
    if cfg.family == "hybrid":
        n_p = cfg.num_layers // cfg.hybrid.period
        attn = n_p * 2 * B * S * cfg.num_kv_heads * cfg.hd * 2
        s = cfg.ssm
        di = s.expand * cfg.d_model
        mamba = (cfg.num_layers - n_p) * B * (di * s.d_state * 4
                                              + (s.d_conv - 1) * di * 2)
        return attn + mamba
    if cfg.mla:
        m = cfg.mla
        return cfg.num_layers * B * S * (m.kv_lora_rank + m.qk_rope_dim) * 2
    return cfg.num_layers * 2 * B * S * cfg.num_kv_heads * cfg.hd * 2
