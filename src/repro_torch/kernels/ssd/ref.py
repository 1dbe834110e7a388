"""The plain PyTorch version of the SSD intra-chunk kernel.

A line-for-line counterpart of ``repro/kernels/ssd/ref.py``: the
materialised (Q, Q) decay matrix with its exponent masked before the
exp, f32 scores, ``w`` rounded to x's type before ``w @ x``, and
``S_loc`` from f32 operands.

``row_errors`` (the flash-attention family's) is how the kernel is held
against it, beside the JAX package's element-wise tolerances: each row
of ``y`` (a token) or ``S_loc`` (a state row) has its L2 error taken
relative to its own L2 size, which does not shrink with the chunk.
"""

from __future__ import annotations

import torch

from ..flash_attention.ref import row_errors

__all__ = ["DT_RANGE", "NEG", "ROW_RTOL", "STATE_ROW_RTOL", "row_errors",
           "ssd_chunks", "ssd_inputs", "ssd_intra_chunk_ref"]

NEG = -1e30
#: the largest ``row_errors`` of y the kernel may show against this
#: version, per working type: bf16 rounds w and y to 8 significant bits,
#: so a w and then a y rounded the other way move a short row by up to
#: 2 * 2^-8 (8.2e-3 measured on an H100 at S 32,768); f32 differs only in
#: the order of the products' sums
ROW_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
#: the same for the f32 states (S_loc, a scan's final state): with bf16
#: inputs the kernel splits B .* dt .* decay into bf16 hi + lo, a residue
#: of ~2^-17 per product
STATE_ROW_RTOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}
#: the range of Mamba-2's dt init, log-uniform, from which ``ssd_inputs``
#: draws each head's dt_bias (chunk decays at Q 256 then exceed 1e-2)
DT_RANGE = (1e-3, 1e-1)


def ssd_intra_chunk_ref(a: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a, dt: (B, H, nc, Q, 1); Bm, Cm: (B, nc, Q, N); x: (B, H, nc, Q,
    hd) -> (y (B, H, nc, Q, hd) in x's type, S_loc (B, H, nc, N, hd) f32,
    dec (B, H, nc, 1, 1) f32)."""
    Q = x.shape[3]
    af = a[..., 0].float()                                   # (B,H,nc,Q)
    dtf = dt[..., 0].float()
    # along a strided dim: torch then scans each row in order on the card
    # (its innermost-dim scan is a tree), the kernel's order
    cum = torch.cumsum(af[..., None], dim=-2)[..., 0]        # (B,H,nc,Q)
    dmat = cum[..., :, None] - cum[..., None, :]             # (B,H,nc,Q,Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri, dmat, NEG))
    scores = torch.einsum("bcin,bcjn->bcij", Cm.float(),
                          Bm.float())                        # (B,nc,Q,Q)
    w = scores[:, None] * L * dtf[..., None, :]              # (B,H,nc,Q,Q)
    y = torch.einsum("bhcij,bhcjd->bhcid", w.to(x.dtype), x)

    cum_last = cum[..., -1:]                                 # (B,H,nc,1)
    decay = torch.exp(cum_last - cum)                        # (B,H,nc,Q)
    xw = x.float() * (dtf * decay)[..., None]
    s_loc = torch.einsum("bcjn,bhcjd->bhcnd", Bm.float(), xw)
    dec = torch.exp(cum_last)[..., None]                     # (B,H,nc,1,1)
    return y.to(x.dtype), s_loc, dec


def ssd_inputs(B: int, S: int, dtype: torch.dtype, seed: int, H: int = 64,
               hd: int = 64, N: int = 128, device: str = "cuda"
               ) -> tuple[torch.Tensor, ...]:
    """Inputs of the scan as mamba2's layer makes them (its defaults are
    mamba2-1.3b's heads), drawn on ``device`` from ``seed``: x (B, S, H,
    hd) N(0, 1) * 0.5 and Bm, Cm (B, S, N) N(0, 1) * 0.3 in ``dtype``;
    in f32, dt (B, S, H) = softplus(z + dt_bias) with z ~ N(0, 1) and
    each head's dt_bias softplus^-1 of a log-uniform draw in
    ``DT_RANGE`` (Mamba-2's init), and A = -exp(log(linspace(1, 16, H)))
    (mamba2's A_log)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((B, S, H, hd), generator=gen, device=device) * 0.5
         ).to(dtype)
    lo, hi = (float(v) for v in torch.log(torch.tensor(DT_RANGE)))
    u = torch.exp(torch.empty(H, device=device).uniform_(lo, hi,
                                                         generator=gen))
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=device)
        + torch.log(torch.expm1(u)))
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device=device)))
    Bm, Cm = ((torch.randn((B, S, N), generator=gen, device=device) * 0.3)
              .to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


def ssd_chunks(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
               ) -> tuple[torch.Tensor, ...]:
    """The intra-chunk contract (a, dt, Bm, Cm, x) as views of the
    sequence-major scan inputs, S a multiple of ``chunk``: what
    ``ops.ssd_scan`` hands the kernel."""
    B, S, H, hd = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    a = (dt * A).view(B, nc, chunk, H).permute(0, 3, 1, 2)[..., None]
    return (a, dt.view(B, nc, chunk, H).permute(0, 3, 1, 2)[..., None],
            Bm.view(B, nc, chunk, N), Cm.view(B, nc, chunk, N),
            x.view(B, nc, chunk, H, hd).permute(0, 3, 1, 2, 4))
