"""mamba2-1.3b — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060; unverified]
48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128.

Pure Mamba-2: d_inner = 2*d_model = 4096, SSD head_dim=64 -> 64 heads,
d_state=128, chunked SSD with chunk=256.  No attention, no FFN (the Mamba
block IS the layer); an untied lm_head.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=64,        # SSD heads = d_inner / head_dim
    num_kv_heads=64,
    d_ff=0,
    vocab=50280,
    norm_eps=1e-5,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256,
                  variant="ssd"),
    source="arXiv:2405.21060",
)
