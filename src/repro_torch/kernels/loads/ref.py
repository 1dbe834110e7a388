"""Plain version of the ordered per-bin sum (the kernel's oracle and the
CPU path): ``torch.bincount`` on CPU tensors, which adds each input's
weight into its bin one element after another, in input order, as
``np.bincount`` (the JAX package's load sums) does."""

from __future__ import annotations

import torch


def ordered_bin_sum_ref(keys: torch.Tensor, weights: torch.Tensor,
                        n_bins: int) -> torch.Tensor:
    """The arguments and result of ``ops.ordered_bin_sum``, on CPU
    tensors."""
    return torch.bincount(keys, weights=weights,
                          minlength=n_bins + 1)[:n_bins]
