"""The plain PyTorch version of the selective-scan kernel.

The reference's step loop (``repro/models/ssm.py::mamba1_forward``, its
``lax.scan`` over time) in torch ops and in the reference's order: from
h₀ = 0, per step ``dA = exp(dt_t · A)`` and ``dBx = (dt_t · B_t) · x_t``
in f32, ``h = dA · h + dBx``, then ``y_t = Σ_n h[n] · C_t[n]``.  About
twelve launches a step on the card, so it is the CPU path, the tests'
oracle and ``chip_smoke.py``'s yardstick, and nothing on the card's
main path.

``row_errors`` (the flash-attention family's) is how the kernel is held
against it: each row of ``y`` (a token's channels) and of the final
state (a channel's N states) has its L2 error taken relative to its own
L2 size.
"""

from __future__ import annotations

import torch

from ..flash_attention.ref import row_errors

__all__ = ["DT_RANGE", "ROW_RTOL", "row_errors", "scan_inputs",
           "selective_scan_ref"]

#: the largest ``row_errors`` of y and of the final state the kernel may
#: show against this version.  Both compute in f32 whatever x's type (x,
#: B and C convert exactly), the update and the exponentials rounded at
#: the same points; they differ only in the order of y's sum over the N
#: states
ROW_RTOL = 1e-5
#: the range of Mamba's dt init, log-uniform, from which ``scan_inputs``
#: draws dt (the state then carries: the largest step decay exceeds 0.5)
DT_RANGE = (1e-3, 1e-1)


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) bf16 or f32; dt: (B, S, D) f32; A: (D, N) f32; Bm, Cm:
    (B, S, N) in x's type -> (y (B, S, D) f32, the final state (B, D, N)
    f32)."""
    Bsz, S, D = x.shape
    N = A.shape[-1]
    h = torch.zeros((Bsz, D, N), dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, S, D), dtype=torch.float32, device=x.device)
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    for t in range(S):
        dt_t = dt[:, t, :, None]                                 # (B, D, 1)
        dA = torch.exp(dt_t * A)                                 # (B, D, N)
        dBx = dt_t * Bf[:, t, None, :] * xf[:, t, :, None]
        h = dA * h + dBx
        y[:, t] = torch.einsum("bin,bn->bi", h, Cf[:, t])
    return y, h


def scan_inputs(B: int, S: int, D: int, dtype: torch.dtype, seed: int,
                N: int = 16, R: int = 512, device: str = "cuda"
                ) -> tuple[torch.Tensor, ...]:
    """Inputs of the scan as Mamba-1 makes them, drawn on ``device`` from
    ``seed``: x (B, S, D) and B, C (B, S, N) in ``dtype``, B and C column
    slices of one (B, S, R + 2N) projection (x_proj's output); dt (B, S,
    D) f32 log-uniform in ``DT_RANGE``; A (D, N) f32, the reference's
    -exp(log(1..N))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, S, D), generator=gen, device=device).to(dtype)
    dbc = torch.randn((B, S, R + 2 * N), generator=gen,
                      device=device).to(dtype)
    _, Bm, Cm = dbc.split([R, N, N], dim=-1)
    lo, hi = (float(v) for v in torch.log(torch.tensor(DT_RANGE)))
    dt = torch.exp(torch.empty((B, S, D), device=device).uniform_(
        lo, hi, generator=gen))
    A = -torch.exp(torch.log(torch.arange(
        1, N + 1, dtype=torch.float32, device=device))).expand(D, N)
    return x, dt, A.contiguous(), Bm, Cm
