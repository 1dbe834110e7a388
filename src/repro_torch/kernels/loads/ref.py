"""Plain version of the ordered (seed, link) load sum (the kernel's
oracle and the CPU path): ``torch.bincount`` on CPU tensors over the
cells' (seed, link) keys in C order, which adds each cell's weight into
its bin one cell after another, in input order, as ``np.bincount`` (the
JAX package's load sums) does."""

from __future__ import annotations

import torch


def ordered_cell_sum_ref(link_ids: torch.Tensor, weights: torch.Tensor,
                         num_links: int) -> torch.Tensor:
    """The arguments and result of ``ops.ordered_cell_sum``, on CPU
    tensors."""
    H, N, S = link_ids.shape
    SL = S * num_links
    ids = link_ids.to(torch.int64)
    off = torch.arange(S, dtype=torch.int64) * num_links
    keys = torch.where((ids >= 0) & (ids < num_links), ids + off, SL)
    w = weights[None, :, None].expand(H, N, S).reshape(-1)
    return torch.bincount(keys.reshape(-1), weights=w,
                          minlength=SL + 1)[:SL].reshape(S, num_links)
