"""Ordered per-bin float64 sums on the card.

``ordered_bin_sum(keys, weights, n_bins)`` adds each element's float64
weight into bin ``keys[i]``, every bin's weights left to right in input
order: the order of ``torch.bincount`` on the CPU and of ``np.bincount``
(the JAX package's link-load sums), so the sums are theirs bit for bit
for any weights.  ``torch.bincount`` on the card adds with atomics in an
order that changes from run to run.

On the card a bin's run of positions comes from a stable sort of the
keys (``torch.sort``: a sort, not the sum) and the run's bounds from
integer counts and their cumulative sum (``sort_runs``); the kernel in
``csrc/loads.cu`` folds each run left to right, one thread a bin
(``fold_runs``).  A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel
launches (CPU calls never count).
"""

from __future__ import annotations

from fractions import Fraction

import torch

from . import build
from .ref import ordered_bin_sum_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"ordered_bin_sum": 0}

_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def exact_in_any_order(weights: torch.Tensor, n_terms: int) -> bool:
    """Whether float64 sums of up to ``n_terms`` of ``weights`` come out
    the same in any order, so that atomic adds give the ordered sum's
    bits.

    True when every weight is finite and an integer multiple of one power
    of two, 2**q, and ``n_terms * max|w| < 2**53 * 2**q``: every partial
    sum is then an integer multiple of 2**q below 2**53 * 2**q in
    magnitude, which float64 holds exactly, so no add rounds.  Unit
    demand, flowlet fractions 1/K with K a power of two and the wave's
    unit weights pass; byte-proportional weights of mixed sizes do not.
    One host synchronisation."""
    w = weights.abs().reshape(-1).to(torch.float64)
    if w.numel() == 0:
        return True
    m, e = torch.frexp(w)                  # w = m * 2**e, m in [0.5, 1)
    mant = (m * 2.0**53).to(torch.int64)   # an integer below 2**53
    low = torch.frexp((mant & -mant).to(torch.float64))[1] - 1
    q = torch.where(w > 0, e - 53 + low, _INT32_MAX).min()
    finite, q, top = torch.stack([
        torch.isfinite(w).all().to(torch.float64), q.to(torch.float64),
        torch.where(torch.isfinite(w), w, 0.0).max()]).tolist()
    if not finite:
        return False
    if top == 0.0:
        return True
    return n_terms * (Fraction(top) / Fraction(2) ** int(q)) < 2**53


def sort_runs(keys: torch.Tensor,
              n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each bin's run of positions, in input order: ``perm`` (M,) int64,
    the positions of a stable sort of ``keys`` (a bin's positions are
    contiguous and ascending), and ``start`` (n_bins + 1,) int64, bin
    ``b``'s run being ``perm[start[b]:start[b + 1]]``.  Keys at or above
    ``n_bins`` sort after every bin's run.  Torch ops, on any device."""
    perm = torch.sort(keys, stable=True).indices
    counts = torch.bincount(keys, minlength=n_bins + 1)[:n_bins]
    start = torch.zeros(n_bins + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=start[1:])
    return perm, start


def fold_runs(perm: torch.Tensor, start: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors from ``sort_runs``: (n_bins,)
    float64, bin ``b`` the left fold from 0.0 of
    ``weights[perm[start[b]:start[b + 1]]]``."""
    n_bins = start.numel() - 1
    out = torch.empty(n_bins, dtype=torch.float64, device=weights.device)
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().ordered_bin_sum(
            perm.data_ptr(), start.data_ptr(), weights.data_ptr(),
            out.data_ptr(), n_bins, stream)
    if rc != 0:
        raise RuntimeError(
            f"ordered_bin_sum launch failed with CUDA error {rc}")
    LAUNCHES["ordered_bin_sum"] += 1
    return out


def ordered_bin_sum(keys: torch.Tensor, weights: torch.Tensor,
                    n_bins: int) -> torch.Tensor:
    """(M,) int32 ``keys`` and (M,) float64 ``weights`` -> (n_bins,)
    float64: bin ``b`` sums ``weights[i]`` over ``keys[i] == b`` in
    order of ``i``, from 0.0.  Keys at or above ``n_bins`` are skipped;
    negative keys raise."""
    if keys.dtype != torch.int32 or weights.dtype != torch.float64:
        raise TypeError(f"keys must be int32 and weights float64, got "
                        f"{keys.dtype} and {weights.dtype}")
    if keys.dim() != 1 or keys.shape != weights.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and weights "
                         f"{tuple(weights.shape)} must be one 1-D shape")
    if not (keys.is_contiguous() and weights.is_contiguous()):
        raise ValueError("ordered_bin_sum needs contiguous tensors")
    if keys.device != weights.device:
        raise ValueError(f"tensors on {keys.device} and {weights.device}")
    if not 0 <= n_bins < _INT32_MAX:
        raise ValueError(f"{n_bins} bins: the skip key n_bins must fit "
                         f"in int32")
    dev = keys.device
    if dev.type == "cpu":
        return ordered_bin_sum_ref(keys, weights, n_bins)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return fold_runs(*sort_runs(keys, n_bins), weights)
