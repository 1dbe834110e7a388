"""Plain PyTorch version of the murmur3 flow hash (the kernel's oracle).

The same seed-as-init chain as ``csrc/flowhash.cu`` and the JAX
package's ``murmur_fold``/``murmur_fmix``, written on int64 tensors:
PyTorch has no ``>>`` or ``%`` for ``uint32`` on the CPU, so every value
is held as a non-negative int64 below 2**32 and masked back to 32 bits
after each multiply and shift.  An int64 multiply wraps modulo 2**64,
which leaves its low 32 bits exact, so the mask recovers the uint32
product bit for bit.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def murmur_fold(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k = (k * _C1) & _MASK32
    k = _rotl(k, 15)
    k = (k * _C2) & _MASK32
    h = _rotl(h ^ k, 13)
    return (h * 5 + 0xE6546B64) & _MASK32


def murmur_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * _F1) & _MASK32
    h = h ^ (h >> 13)
    h = (h * _F2) & _MASK32
    return h ^ (h >> 16)


def murmur_hash_grid_ref(fields: torch.Tensor,
                         dev_seed: torch.Tensor) -> torch.Tensor:
    """fields: (N, F) int64; dev_seed: (N, S) int64 (any 64-bit pattern,
    broadcastable) -> (N, S) int64 hashes in [0, 2**32).  The seed and
    every field are truncated to their low 32 bits first."""
    h = dev_seed & _MASK32
    f32 = fields & _MASK32
    for f in range(fields.shape[1]):
        h = murmur_fold(h, f32[:, f : f + 1])
    return murmur_fmix(h)
