"""qwen2-vl-72b — VLM backbone (qwen2-72b body + M-RoPE).
[arXiv:2409.12191; hf]
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

The vision frontend (dynamic-resolution ViT) is a STUB per the
assignment: input_specs() provides precomputed patch/token embeddings
(B, S, d_model) plus M-RoPE position ids (3, B, S) = (temporal, height,
width) streams; mrope_section=[16, 24, 24] half-dims as in the HF config.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191 / hf:Qwen/Qwen2-VL-72B-Instruct",
)
