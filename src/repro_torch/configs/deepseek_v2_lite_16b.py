"""deepseek-v2-lite-16b — MoE with Multi-head Latent Attention (MLA).
[arXiv:2405.04434; hf]
27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, MLA kv_lora=512.

NOTE on the assignment line: the header says "MoE 64e top-6" while the
inline note says "2 shared+160 routed top-6".  160 routed is full
DeepSeek-V2 (236B); V2-*Lite* has 64 routed + 2 shared experts, top-6
(HF config: n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
moe_intermediate_size=1408, first_k_dense_replace=1, kv_lora_rank=512,
qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128).  We follow the
header + HF config (64 routed); recorded in DESIGN.md §Arch-applicability.
"""

from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,   # MLA: per-head KV reconstructed from the shared latent
    d_ff=10944,        # the single dense layer's FFN width (HF: intermediate_size)
    vocab=102400,
    rope_theta=10000.0,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared=2,
        first_dense_layers=1,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        q_lora_rank=0,
    ),
    source="arXiv:2405.04434 / hf:deepseek-ai/DeepSeek-V2-Lite",
)
