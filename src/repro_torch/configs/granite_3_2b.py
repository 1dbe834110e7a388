"""granite-3-2b — dense GQA transformer.
[hf:ibm-granite/granite-3.0-2b-base; hf]
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=49155,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
