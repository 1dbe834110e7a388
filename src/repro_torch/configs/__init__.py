"""Architecture registry of the port: only the architectures it runs."""

from __future__ import annotations

from .base import (
    ArchConfig, DECODE_32K, EncDecConfig, HybridConfig, LONG_500K, MLAConfig,
    MoEConfig, PREFILL_32K, SHAPES, SSMConfig, ShapeConfig, TRAIN_4K,
)
from .granite_3_2b import CONFIG as GRANITE_3_2B
from .mamba2_13b import CONFIG as MAMBA2_13B

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (GRANITE_3_2B,
                                                      MAMBA2_13B)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; the port "
                       f"runs {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ArchConfig", "ShapeConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "HybridConfig", "EncDecConfig", "SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "ARCHS", "get_arch",
    "GRANITE_3_2B", "MAMBA2_13B",
]
