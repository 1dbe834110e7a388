"""What the hand-written kernels need of a tensor's layout."""

from __future__ import annotations

import torch


def check_rows(name: str, t: torch.Tensor) -> None:
    """The kernels read rows through strides but need a unit last-dim
    stride and, for bf16, 16-byte aligned rows (they load 8 values at a
    time); raise otherwise."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride on its last dim, "
                         f"got strides {t.stride()}")
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1])):
        raise ValueError(f"bf16 {name} needs a 16-byte aligned start and "
                         f"strides divisible by 8, got strides {t.stride()}")
