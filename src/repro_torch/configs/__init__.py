"""Architecture registry of the port: only the architectures it runs."""

from __future__ import annotations

from .base import (
    ArchConfig, DECODE_32K, EncDecConfig, HybridConfig, LONG_500K, MLAConfig,
    MoEConfig, PREFILL_32K, SHAPES, SSMConfig, ShapeConfig, TRAIN_4K,
    applicable_shapes,
)
from .codeqwen15_7b import CONFIG as CODEQWEN15_7B
from .deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE_16B
from .glm4_9b import CONFIG as GLM4_9B
from .granite_3_2b import CONFIG as GRANITE_3_2B
from .jamba_15_large_398b import CONFIG as JAMBA_15_LARGE_398B
from .mamba2_13b import CONFIG as MAMBA2_13B
from .qwen2_72b import CONFIG as QWEN2_72B
from .qwen2_moe_a27b import CONFIG as QWEN2_MOE_A27B
from .qwen2_vl_72b import CONFIG as QWEN2_VL_72B
from .whisper_large_v3 import CONFIG as WHISPER_LARGE_V3

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (GRANITE_3_2B, GLM4_9B, CODEQWEN15_7B, QWEN2_72B,
              DEEPSEEK_V2_LITE_16B, QWEN2_MOE_A27B, JAMBA_15_LARGE_398B,
              WHISPER_LARGE_V3, QWEN2_VL_72B, MAMBA2_13B)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; the port "
                       f"runs {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[ArchConfig, ShapeConfig]]:
    """Every (arch x shape) cell of the architectures the port runs."""
    return [(a, s) for a in ARCHS.values() for s in applicable_shapes(a)]


__all__ = [
    "ArchConfig", "ShapeConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "HybridConfig", "EncDecConfig", "SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "applicable_shapes", "ARCHS", "get_arch",
    "get_shape", "all_cells", "CODEQWEN15_7B", "DEEPSEEK_V2_LITE_16B",
    "GLM4_9B", "GRANITE_3_2B", "JAMBA_15_LARGE_398B", "MAMBA2_13B",
    "QWEN2_72B", "QWEN2_MOE_A27B", "QWEN2_VL_72B", "WHISPER_LARGE_V3",
]
