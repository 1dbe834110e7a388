"""Architecture + shape configuration: the port of
``repro/configs/base.py``.

Plain frozen dataclasses, field for field the JAX package's, so a config
compares equal to the reference's by ``dataclasses.asdict``.  Only
``param_dtype`` differs: it returns a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    every_k_layers: int = 1
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    impl: str = "tp"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    variant: str = "ssd"


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    period: int = 8
    attn_index: int = 7


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 32
    encoder_seq: int = 1500


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    mrope_sections: Optional[tuple[int, int, int]] = None
    sliding_window: int = 0          # >0: windowed attention
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """May run the long_500k cell (SSM / hybrid with windowed attn)."""
        return self.family in ("ssm", "hybrid")

    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (the reference's rule)."""
        changes: dict = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, d_ff_expert=64,
                num_shared=min(self.moe.num_shared, 1),
            )
        if self.mla:
            changes["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
                v_head_dim=32, q_lora_rank=0,
            )
            changes["head_dim"] = 0
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.hybrid:
            changes["num_layers"] = self.hybrid.period
        if self.encdec:
            changes["encdec"] = dataclasses.replace(
                self.encdec, num_encoder_layers=2, encoder_seq=16)
        if self.mrope_sections:
            hd = changes.get("head_dim") or changes["d_model"] // changes["num_heads"]
            total = hd // 2
            old = self.mrope_sections
            s0 = max(1, total * old[0] // sum(old))
            s1 = max(1, total * old[1] // sum(old))
            changes["mrope_sections"] = (s0, s1, total - s0 - s1)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def applicable_shapes(arch: ArchConfig) -> list[ShapeConfig]:
    """The assigned cells for this arch: long_500k only for
    sub-quadratic families."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch.sub_quadratic:
        shapes.append(LONG_500K)
    return shapes
