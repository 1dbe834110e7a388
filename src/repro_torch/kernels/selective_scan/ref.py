"""The plain PyTorch versions of the selective-scan kernels, forward
and backward.

The reference's step loop (``repro/models/ssm.py::mamba1_forward``, its
``lax.scan`` over time) in torch ops and in the reference's order: from
h₀ = 0, per step ``dA = exp(dt_t · A)`` and ``dBx = (dt_t · B_t) · x_t``
in f32, ``h = dA · h + dBx``, then ``y_t = Σ_n h[n] · C_t[n]``.  About
twelve launches a step on the card, so it is the CPU path, the tests'
oracle and ``chip_smoke.py``'s yardstick, and nothing on the card's
main path.  ``selective_scan_bwd_ref`` is the backward's plain version:
the forward's states again, then the reverse recurrence of their
cotangents in torch ops, one step at a time.

``row_errors`` (the flash-attention family's) is how the kernel is held
against it: each row of ``y`` (a token's channels) and of the final
state (a channel's N states) has its L2 error taken relative to its own
L2 size.
"""

from __future__ import annotations

import torch

from ..flash_attention.ref import row_errors

__all__ = ["BWD_RTOL", "DT_RANGE", "ROW_RTOL", "row_errors", "scan_inputs",
           "selective_scan_bwd_ref", "selective_scan_ref"]

#: the largest ``row_errors`` of y and of the final state the kernel may
#: show against this version.  Both compute in f32 whatever x's type (x,
#: B and C convert exactly), the update and the exponentials rounded at
#: the same points; they differ only in the order of y's sum over the N
#: states
ROW_RTOL = 1e-5
#: the backward kernel against ``selective_scan_bwd_ref``: the largest
#: ``row_errors`` of dx and ddt (a token's channels), and the largest
#: |difference| of dA, dB and dC relative to each one's largest |value|.
#: Both compute in f32 from the same states (the kernel replays the
#: forward's rounding); they differ in the order of the sums over states,
#: channels (dB, dC) and steps (dA), and where the kernel fuses a
#: multiply-add
BWD_RTOL = 1e-5
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


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor, gy: torch.Tensor,
                           gh: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan_ref`` in its inputs, given the
    cotangent ``gy`` (B, S, D) f32 of y and ``gh`` (B, D, N) f32 of the
    final state (None: zero).  With a_t = exp(dt_t·A) and the carry
    g_t = gy_t·C_t + a_{t+1}·g_{t+1} (g after the last step: gh):

        dC_t[n] = Σ_d gy_t[d]·h_t[d, n]
        dB_t[n] = Σ_d g_t[d, n]·dt_t[d]·x_t[d]
        dx_t[d] = dt_t[d]·Σ_n g_t[d, n]·B_t[n]
        ddt_t[d] = Σ_n g_t[d, n]·(A[d, n]·a_t[d, n]·h_{t-1}[d, n]
                                  + B_t[n]·x_t[d])
        dA[d, n] = Σ_{b, t} g_t[d, n]·dt_t[d]·a_t[d, n]·h_{t-1}[d, n]

    Returns (dx, ddt (B, S, D), dA (D, N), dB, dC (B, S, N)), all f32."""
    Bsz, S, D = x.shape
    N = A.shape[-1]
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    hs = torch.empty((S, Bsz, D, N), dtype=torch.float32, device=x.device)
    h = torch.zeros((Bsz, D, N), dtype=torch.float32, device=x.device)
    for t in range(S):                      # the forward's states h_t
        dt_t = dt[:, t, :, None]
        h = torch.exp(dt_t * A) * h + dt_t * Bf[:, t, None, :] * \
            xf[:, t, :, None]
        hs[t] = h
    g = (torch.zeros_like(h) if gh is None else gh.float().clone())
    zero = torch.zeros_like(h)
    dx = torch.empty((Bsz, S, D), dtype=torch.float32, device=x.device)
    ddt = torch.empty_like(dx)
    dB = torch.empty((Bsz, S, N), dtype=torch.float32, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros((D, N), dtype=torch.float32, device=x.device)
    for t in reversed(range(S)):
        dt_t = dt[:, t, :, None]                                 # (B, D, 1)
        a = torch.exp(dt_t * A)                                  # (B, D, N)
        g = g + gy[:, t, :, None] * Cf[:, t, None, :]
        ah = a * (hs[t - 1] if t else zero)                      # a_t h_{t-1}
        dC[:, t] = torch.einsum("bd,bdn->bn", gy[:, t], hs[t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g * dt_t, xf[:, t])
        dx[:, t] = dt[:, t] * torch.einsum("bdn,bn->bd", g, Bf[:, t])
        ddt[:, t] = (g * (A * ah + Bf[:, t, None, :] * xf[:, t, :, None])
                     ).sum(-1)
        dA += (g * dt_t * ah).sum(0)
        g = a * g                                                # carry
    return dx, ddt, dA, dB, dC


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
