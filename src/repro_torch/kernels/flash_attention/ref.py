"""The plain PyTorch version of the flash-attention kernel.

``attention_ref``'s semantics (``repro/kernels/flash_attention/ref.py``:
materialised softmax in f32, output in q's type) with the grouped-query
head map of the kernel: query head h reads kv head h // (H / Hkv).

``row_errors`` is how the kernel is held against it.  An element-wise
limit does not scale with the sequence: a causal row i averages about
i / e keys' values, so its entries shrink as 1 / √i (about 0.009 at
S 32,768 for unit-normal inputs), and an absolute 2e-2 there passes a
kernel that skips a whole key tile.  The error of each query row,
relative to that row's own size, does not shrink: a skipped 64-key tile
moves some rows of a 32,768-key band by 14-30 %, while the kernel's bf16
rounding of p stays near 0.4 %.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
#: score bytes one chunk of query rows may materialise
_CHUNK_BYTES = 1 << 30
#: the largest ``row_errors`` the kernel may show against this version:
#: bf16 rounds p before p @ v and rounds the output (at most 5.1e-3 per
#: row on an H100 at S 1,000 to 32,768, chip_smoke.py); f32 differs only
#: in summation order (at most 3.3e-6 there)
ROW_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| / |want| for each query row: the L2 norms over the
    head dim of (B, H, S, hd) outputs, computed in f32 -> (B, H, S)."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(torch.finfo(torch.float32).tiny))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd) -> (B, H, Sq, hd) in q's
    type.  Query row i sits at key position ``q_offset + i`` for the
    causal mask (0 for self-attention; a band of the last rows of a long
    sequence passes its start).  Query rows are taken in chunks so that
    no chunk's f32 scores exceed 1 GiB."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, Sq, hd)
    kt = k.float().transpose(-1, -2)                 # (B, Hkv, hd, Sk)
    vf = v.float()
    rows = max(1, _CHUNK_BYTES // (4 * B * H * max(Sk, 1)))
    k_pos = torch.arange(Sk, device=q.device)
    out = []
    for r0 in range(0, Sq, rows):
        qc = qf[:, :, :, r0:r0 + rows]
        n = qc.shape[3]
        s = (qc.reshape(B, Hkv, G * n, hd) @ kt).reshape(B, Hkv, G, n, Sk)
        s = s / math.sqrt(hd)
        if causal:
            q_pos = q_offset + r0 + torch.arange(n, device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
        p = torch.softmax(s, dim=-1).reshape(B, Hkv, G * n, Sk)
        out.append((p @ vf).reshape(B, Hkv, G, n, hd))
    return torch.cat(out, dim=-2).reshape(B, H, Sq, hd).to(q.dtype)
