"""qwen2-moe-a2.7b — MoE: 60 routed top-4 + shared expert (4x1408 fused).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (kv=16) d_ff(expert)=1408 vocab=151936."""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,         # shared-expert width (= 4 x 1408, per HF config)
    vocab=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_ff_expert=1408,
        num_shared=4,   # fused shared expert of width 4*1408=5632
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
