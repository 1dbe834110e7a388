"""Ordered (seed, link) load sums on the card.

``ordered_cell_sum(link_ids, weights, num_links)`` sums the demand of an
``(H, N, S)`` tensor of int32 link ids (-1 for no link) into (S, L)
float64 bins: bin (s, l) adds ``weights[n]`` over the cells (h, n, s)
that hold l, in order of (h, n), from 0.0.  That is the order of
``np.bincount`` over the cells in C order (the JAX package's
``_weighted_link_loads``) and of ``torch.bincount`` on the CPU, so the
sums are theirs bit for bit for any weights.  ``torch.bincount`` on the
card adds with atomics in an order that changes from run to run.

On the card one launch of ``csrc/loads.cu`` reads the link ids and the
(N,) weights as they are (no keys, no weight per cell, no sort): each
CTA owns one seed's bins (all its links, or ``plan``'s share of them),
a cluster of 8 brings in the rows of its 8 seeds once, and each CTA
ranks its tiles of cells stably in shared memory and adds every bin's
weights in order.  A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version in ``ref.py``.
``LAUNCHES`` counts kernel launches (CPU calls never count).
"""

from __future__ import annotations

import math

import torch

from . import build
from .ref import ordered_cell_sum_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"ordered_cell_sum": 0}

#: bins one CTA owns (``MAX_KEYS`` in ``csrc/loads.cu``)
MAX_KEYS = 1024

_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def plan(links: int) -> int:
    """The links one CTA owns of its seed: a seed's links split evenly
    over the fewest CTAs that hold at most ``MAX_KEYS`` each."""
    fit = math.ceil(links / MAX_KEYS) if links > 0 else 1
    return max(1, math.ceil(links / fit))


def ordered_cell_sum(link_ids: torch.Tensor, weights: torch.Tensor,
                     num_links: int) -> torch.Tensor:
    """(H, N, S) int32 ``link_ids`` and (N,) float64 ``weights`` ->
    (S, num_links) float64: bin (s, l) sums ``weights[n]`` over the
    cells (h, n, s) equal to l in order of (h, n), from 0.0.  Cells
    outside [0, num_links) are skipped."""
    if link_ids.dtype != torch.int32 or weights.dtype != torch.float64:
        raise TypeError(f"link ids must be int32 and weights float64, got "
                        f"{link_ids.dtype} and {weights.dtype}")
    if link_ids.dim() != 3 or weights.shape != link_ids.shape[1:2]:
        raise ValueError(f"link ids {tuple(link_ids.shape)} must be (H, N, "
                         f"S) and weights {tuple(weights.shape)} (N,)")
    if not (link_ids.is_contiguous() and weights.is_contiguous()):
        raise ValueError("ordered_cell_sum needs contiguous tensors")
    if link_ids.device != weights.device:
        raise ValueError(f"tensors on {link_ids.device} and "
                         f"{weights.device}")
    if not 0 <= num_links < _INT32_MAX:
        raise ValueError(f"{num_links} links: must fit in int32")
    dev = link_ids.device
    if dev.type == "cpu":
        return ordered_cell_sum_ref(link_ids, weights, num_links)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    H, N, S = link_ids.shape
    out = torch.empty((S, num_links), dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().ordered_cell_sum(
            link_ids.data_ptr(), weights.data_ptr(), out.data_ptr(), H * N,
            N, S, num_links, plan(num_links), stream)
    if rc != 0:
        raise RuntimeError(
            f"ordered_cell_sum launch failed with CUDA error {rc}")
    LAUNCHES["ordered_cell_sum"] += 1
    return out
