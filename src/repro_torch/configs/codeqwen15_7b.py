"""codeqwen1.5-7b — dense transformer, full MHA (kv=32), QKV bias.
[hf:Qwen/CodeQwen1.5-7B; hf]
32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416 — qwen1.5-arch."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1000000.0,  # CodeQwen long-context rope base
    source="hf:Qwen/CodeQwen1.5-7B",
)
