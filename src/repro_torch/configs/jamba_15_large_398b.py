"""jamba-1.5-large-398b — hybrid Mamba+attention (1:7) with MoE (16e top-2).
[arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.

Structure (Jamba paper): blocks of 8 layers with 1 attention layer per
block (ratio 1:7); MoE replaces the dense MLP every other layer (e=16,
top-2).  Jamba uses Mamba-1 selective-scan layers (d_state=16, conv=4,
expand=2) — we keep that variant; mamba2-1.3b exercises SSD.

long_500k: runs (hybrid is sub-quadratic: mamba layers are O(1)/token and
the 9 attention layers use a sliding window at long context).
"""

from .base import ArchConfig, HybridConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_ff_expert=24576,
        every_k_layers=2,   # MoE on odd layers, dense MLP on even
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, variant="mamba1"),
    hybrid=HybridConfig(period=8, attn_index=7),
    sliding_window=4096,    # used by attention layers in the long_500k cell
    source="arXiv:2403.19887 / hf:ai21labs/AI21-Jamba-1.5-Large",
)
