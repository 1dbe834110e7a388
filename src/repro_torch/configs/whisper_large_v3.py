"""whisper-large-v3 — encoder-decoder audio transformer (backbone only).
[arXiv:2212.04356; unverified]
32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866 — enc-dec.

The conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, 1500, d_model) for the encoder.  The
decoder is a standard pre-LN causal transformer with cross-attention.
Whisper uses learned positions + LayerNorm; we keep LN but use RoPE-free
absolute positions for the backbone (positions are part of the stub).
long_500k is SKIPPED (full attention).  decode_* runs (enc-dec has a
decoder; only encoder-only archs skip decode).
"""

from .base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,          # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    norm_eps=1e-5,
    encdec=EncDecConfig(num_encoder_layers=32, encoder_seq=1500),
    source="arXiv:2212.04356",
)
