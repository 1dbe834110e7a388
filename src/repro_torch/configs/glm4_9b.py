"""glm4-9b — dense GQA transformer with aggressive KV compression (kv=2).
[hf:THUDM/glm-4-9b; hf]
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 — RoPE, GQA."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    rope_theta=10000.0,
    qkv_bias=True,  # GLM-4 uses add_qkv_bias=True
    source="hf:THUDM/glm-4-9b",
)
