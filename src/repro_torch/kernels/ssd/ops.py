"""Mamba-2 SSD: the port of ``repro/kernels/ssd/ops.py``.

``ssd_intra_chunk`` is one CUDA kernel (``csrc/ssd.cu``; bf16 on the
tensor cores, by ``wgmma`` with TMA staging at the serving chunk and
``mma.sync`` at the reduced config's; f32 in FMAs) computing, per (batch,
head, chunk of Q tokens), the chunk's own output, its local state and its
decay.  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  ``LAUNCHES`` counts kernel launches (CPU calls
never count), so a run can show that it went through the kernel.

``ssd_scan`` is the whole scan around it: padding, the kernel, the
inter-chunk state recurrence and the inter-chunk output, the last two in
torch ops as the reference leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..layout import check_rows
from . import build
from .ref import ssd_intra_chunk_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"ssd_intra_chunk": 0}
#: the bf16 body of each (Q, N, hd) the kernel is built for, and its heads
#: per block: mamba2-1.3b's chunk on ``wgmma`` (one block per batch, chunk
#: and group of 8 heads) and the reduced config's on ``mma.sync`` (one
#: block per batch, chunk and head), as ``Bf16Body`` in ``csrc/ssd.cu``
#: builds them (the tests and ``chip_smoke.py`` check that the two agree)
BF16_BODIES = {(256, 128, 64): ("wgmma", 8), (32, 16, 16): ("mma.sync", 1)}
#: (Q, N, hd) the kernel is built for, in bf16 and f32
KERNEL_SIZES = tuple(BF16_BODIES)
_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(a, dt, Bm, Cm, x) -> None:
    if x.dim() != 5 or Bm.dim() != 4:
        raise ValueError(f"expected x (B, H, nc, Q, hd) and Bm, Cm (B, nc, "
                         f"Q, N), got {tuple(x.shape)}, {tuple(Bm.shape)}")
    B, H, nc, Q, _ = x.shape
    if tuple(a.shape) != (B, H, nc, Q, 1) or dt.shape != a.shape:
        raise ValueError(f"a, dt must be {(B, H, nc, Q, 1)}, got "
                         f"{tuple(a.shape)}, {tuple(dt.shape)}")
    if Bm.shape[:3] != (B, nc, Q) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm, Cm must be ({B}, {nc}, {Q}, N), got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if (x.dtype not in _DTYPES or Bm.dtype != x.dtype
            or Cm.dtype != x.dtype):
        raise TypeError(f"x, Bm, Cm must share one of {_DTYPES}, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError(f"a and dt must be float32, got {a.dtype}, {dt.dtype}")
    if len({t.device for t in (a, dt, Bm, Cm, x)}) != 1:
        raise ValueError("a, dt, Bm, Cm and x must lie on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")


def ssd_intra_chunk(a: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a = dt·A (negative), dt: (B, H, nc, Q, 1) f32; Bm, Cm: (B, nc, Q,
    N), shared across heads; x: (B, H, nc, Q, hd) -> (y (B, H, nc, Q,
    hd) in x's type, S_loc (B, H, nc, N, hd) f32, dec (B, H, nc, 1, 1)
    f32).  On the card ``y`` is the (B, H, nc, Q, hd) view of a dense
    (B, nc, Q, H, hd) tensor, so a sequence-major x comes back as one."""
    _check(a, dt, Bm, Cm, x)
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(a, dt, Bm, Cm, x)
    B, H, nc, Q, hd = x.shape
    N = Bm.shape[-1]
    if (Q, N, hd) not in KERNEL_SIZES:
        raise ValueError(f"the kernel takes (Q, N, hd) in {KERNEL_SIZES}, "
                         f"got {(Q, N, hd)}")
    for name, t in (("Bm", Bm), ("Cm", Cm), ("x", x)):
        check_rows(name, t)
    y = torch.empty((B, nc, Q, H, hd), dtype=x.dtype,
                    device=x.device).permute(0, 3, 1, 2, 4)
    s_loc = torch.empty((B, H, nc, N, hd), dtype=torch.float32,
                        device=x.device)
    dec = torch.empty((B, H, nc, 1, 1), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, s_loc, dec
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().ssd_intra_chunk(
            a.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            x.data_ptr(), y.data_ptr(), s_loc.data_ptr(), dec.data_ptr(),
            int(x.dtype == torch.bfloat16), B, H, nc, Q, N, hd,
            *a.stride()[:4], *dt.stride()[:4], *Bm.stride()[:3],
            *Cm.stride()[:3], *x.stride()[:4], *y.stride()[:4], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk launch failed with CUDA error {rc}")
    LAUNCHES["ssd_intra_chunk"] += 1
    return y, s_loc, dec


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence from a zero state.  x: (B, S, H, hd);
    dt: (B, S, H) f32; A: (H,) negative f32; Bm, Cm: (B, S, N).  Returns
    (y (B, S, H, hd) in x's type, state (B, H, N, hd) f32).

    The chunks' states are kept as (nc + 1, B, N, H, hd), so that the
    inter-chunk output is one batched product C @ state whose result is
    already sequence-major, like the kernel's ``y``."""
    B, S, H, hd = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:                  # zero rows: dt = 0 leaves S_loc and dec as they are
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = x.shape[1]
    nc = Sp // chunk
    dtf = dt.float().reshape(B, nc, chunk, H)
    a = dtf * A                                              # (B,nc,Q,H)
    xk = x.reshape(B, nc, chunk, H, hd).permute(0, 3, 1, 2, 4)
    Bk = Bm.reshape(B, nc, chunk, N)
    Ck = Cm.reshape(B, nc, chunk, N)
    y, s_loc, dec = ssd_intra_chunk(
        a.permute(0, 3, 1, 2)[..., None], dtf.permute(0, 3, 1, 2)[..., None],
        Bk, Ck, xk)

    # inter-chunk state recurrence: state after chunk c = dec_c * state
    # before it + S_loc_c (a Python loop, as the reference's lax.scan)
    states = torch.empty((nc + 1, B, N, H, hd), dtype=torch.float32,
                         device=x.device)
    states[0].zero_()
    s_loc = s_loc.permute(2, 0, 3, 1, 4)                     # (nc,B,N,H,hd)
    dec = dec[..., 0].permute(2, 0, 3, 1)[..., None]         # (nc,B,1,H,1)
    for c in range(nc):
        torch.addcmul(s_loc[c], dec[c], states[c], out=states[c + 1])

    # y_inter: exp(cum_i) C_i @ (state before chunk c)
    cum = torch.cumsum(a, dim=2)                             # (B,nc,Q,H)
    c_f = Ck.float().transpose(0, 1).reshape(nc * B, chunk, N)
    y_inter = torch.matmul(c_f, states[:nc].reshape(nc * B, N, H * hd))
    y_inter = y_inter.view(nc, B, chunk, H, hd).transpose(0, 1)
    out = torch.empty((B, nc, chunk, H, hd), dtype=torch.float32,
                      device=x.device)
    torch.mul(y_inter, torch.exp(cum)[..., None], out=out)
    out += y.permute(0, 2, 3, 1, 4)                          # y_intra
    y = out.to(x.dtype).view(B, Sp, H, hd)
    if pad:
        y = y[:, :S]
    return y, states[nc].permute(0, 2, 1, 3).contiguous()
