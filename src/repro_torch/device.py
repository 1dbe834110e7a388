"""Where the port runs: the card unless the caller asks for the CPU.

Every public entry point takes ``device=None``.  ``None`` means the CUDA
card; a host without one raises instead of quietly running elsewhere.
Only an explicit ``device="cpu"`` (what the CPU tests pass) runs on the
host, where each kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is
    taken as given, and a CUDA device is still checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available here; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def generator(seed: int, device: str | torch.device | None = None
              ) -> torch.Generator:
    """An explicitly seeded ``torch.Generator`` on the resolved device
    (the port never draws from torch's global generator)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
