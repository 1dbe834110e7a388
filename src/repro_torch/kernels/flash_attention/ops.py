"""Flash-attention forward: the port of
``repro/kernels/flash_attention/ops.py::flash_attention``.

One CUDA kernel (``csrc/flash_attention.cu``: bf16 with TMA and
``wgmma`` on the tensor cores, f32 in FMAs) computes softmax(q kᵀ / √hd)
v, causal or not, over grouped-query layouts given by strides.  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.
``LAUNCHES`` counts kernel launches (CPU calls never count), so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import math

import torch

from ..layout import check_rows
from . import build
from .ref import flash_attention_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"flash_attention": 0}
#: head dims the kernel is built for (template instances)
HEAD_DIMS = (32, 64, 128)
#: the bf16 kernel's blocks for each head dim: (query rows, keys per
#: stage, stages), as ``Bf16Tiles`` in ``csrc/flash_attention.cu`` builds
#: them (the tests and ``chip_smoke.py`` check that the two agree)
BF16_TILES = {32: (192, 128, 2), 64: (192, 128, 3), 128: (128, 128, 2)}
_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B, H, S, hd) and k, v (B, Hkv, S, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    if k.shape[0] != B or k.shape[2:] != (S, hd) or H % k.shape[1]:
        raise ValueError(
            f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}: self-"
            f"attention needs the same B, S and hd and Hkv dividing H")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {_DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) with Hkv dividing H ->
    (B, H, S, hd) in q's type and with q's strides where q is dense (a
    transposed (B, S, H, hd) view comes back as one).  Query head h
    attends with kv head h // (H / Hkv)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    B, H, S, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(name, t)
    out = torch.empty_like(q)
    check_rows("out", out)
    if S == 0:
        return out
    scale = 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, H, k.shape[1], S, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), scale, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed with CUDA error {rc}")
    LAUNCHES["flash_attention"] += 1
    return out
