"""Mamba-1's selective scan and its backward: a CUDA tensor launches the
kernel (``csrc/selective_scan.cu``) or raises; a CPU tensor takes the
plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches (CPU
calls never count), so a run can show that it went through the
kernel."""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import selective_scan_bwd_ref, selective_scan_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"selective_scan": 0, "selective_scan_bwd": 0}
#: channels a block scans (one thread each) and time steps a stage of its
#: two-stage ring holds: ``CHANNELS`` and ``TILE`` in the source (the
#: tests check that the two agree)
BLOCK_CHANNELS, TILE_STEPS = 64, 32
#: the backward's steps between two saved states (a stage of its ring),
#: the steps of a sub-tile whose states and decays it keeps in shared
#: memory, the channels a block walks (two lanes each) and the blocks of a
#: cluster that add their dB and dC sums on chip: ``BWD_TILE``, ``SUB``,
#: ``BWD_CHANNELS`` and ``BWD_CLUSTER`` in the source, for the tests' CPU
#: model of the algorithm (the wrapper asks the library for its scratch)
BWD_TILE_STEPS, BWD_SUB_STEPS, BWD_BLOCK_CHANNELS, BWD_CLUSTER_BLOCKS = \
    8, 4, 128, 2
#: state sizes N the kernel is built for (Jamba's d_state, full and
#: reduced)
KERNEL_STATES = (16,)
_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"expected x (B, S, D) and A (D, N), got "
                         f"{tuple(x.shape)}, {tuple(A.shape)}")
    Bsz, S, D = x.shape
    N = A.shape[1]
    if dt.shape != x.shape or A.shape[0] != D:
        raise ValueError(f"dt must be {tuple(x.shape)} and A ({D}, N), got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    if tuple(Bm.shape) != (Bsz, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm, Cm must be {(Bsz, S, N)}, got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share one of {_DTYPES}, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("x, dt, A, Bm and Cm must lie on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")


def _check_kernel(x, dt, A, Bm, Cm) -> None:
    """What the kernels take beyond ``_check``: N 16 and a unit stride
    along each row."""
    N = A.shape[1]
    if N not in KERNEL_STATES:
        raise ValueError(f"the kernel takes N in {KERNEL_STATES}, got {N}")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last dim, "
                             f"got strides {t.stride()}")


def _strides(x, dt, Bm, Cm) -> tuple[int, ...]:
    """The batch and step strides of x, dt, Bm and Cm, as the kernels
    read them."""
    return (*x.stride()[:2], *dt.stride()[:2], *Bm.stride()[:2],
            *Cm.stride()[:2])


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence h_t = exp(dt_t·A) ⊙ h_{t-1} + (dt_t·B_t)·x_t from
    h₀ = 0, y_t = Σ_n h_t[n]·C_t[n].  x: (B, S, D) bf16 or f32; dt: (B,
    S, D) f32; A: (D, N) f32; Bm, Cm: (B, S, N) in x's type.  Returns (y
    (B, S, D) f32, the final state (B, D, N) f32).  The kernel reads x,
    dt, Bm and Cm through their batch and step strides (the model's B
    and C are column slices of one projection)."""
    _check(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, A, Bm, Cm)
    _check_kernel(x, dt, A, Bm, Cm)
    Bsz, S, D = x.shape
    N = A.shape[1]
    A = A.contiguous()
    y = torch.empty((Bsz, S, D), dtype=torch.float32, device=x.device)
    h = torch.empty((Bsz, D, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().selective_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
            int(x.dtype == torch.bfloat16), Bsz, S, D, N,
            *_strides(x, dt, Bm, Cm), stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed with CUDA error {rc}")
    LAUNCHES["selective_scan"] += 1
    return y, h


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, gy: torch.Tensor,
                       gh: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan`` in x, dt, A, Bm and Cm, given
    the cotangents ``gy`` (B, S, D) f32 of y and ``gh`` (B, D, N) f32 of
    the final state (None: zero).  The inputs as ``selective_scan``
    takes them.  Returns (dx, ddt (B, S, D), dA (D, N), dB, dC (B, S,
    N)), all f32; two runs on the card agree bit for bit (the sums over
    channels and batch rows add block partials in a fixed order)."""
    _check(x, dt, A, Bm, Cm)
    Bsz, S, D = x.shape
    N = A.shape[1]
    if tuple(gy.shape) != (Bsz, S, D) or gy.dtype != torch.float32:
        raise ValueError(f"gy must be float32 {(Bsz, S, D)}, got "
                         f"{gy.dtype} {tuple(gy.shape)}")
    if gh is not None and (tuple(gh.shape) != (Bsz, D, N)
                           or gh.dtype != torch.float32):
        raise ValueError(f"gh must be float32 {(Bsz, D, N)}, got "
                         f"{gh.dtype} {tuple(gh.shape)}")
    if any(t.device != x.device for t in (gy, gh) if t is not None):
        raise ValueError("gy and gh must lie on x's device")
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(x, dt, A, Bm, Cm, gy, gh)
    _check_kernel(x, dt, A, Bm, Cm)
    A, gy = A.contiguous(), gy.contiguous()
    gh = None if gh is None else gh.contiguous()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    dx, ddt, dA = empty(Bsz, S, D), empty(Bsz, S, D), empty(D, N)
    dB, dC = empty(Bsz, S, N), empty(Bsz, S, N)
    if dx.numel() == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_()
    lib = build.load()
    floats = (ctypes.c_longlong * 4)()
    lib.selective_scan_bwd_scratch(Bsz, S, D, N, floats)
    scratch = [empty(n) for n in floats]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), gy.data_ptr(), None if gh is None else
            gh.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), *(t.data_ptr() for t in scratch),
            int(x.dtype == torch.bfloat16), Bsz, S, D, N,
            *_strides(x, dt, Bm, Cm), stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan_bwd launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["selective_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC
