"""Shared model components: RMSNorm, the SwiGLU MLP, rotary embeddings
and the initializer (random, zero and constant parameters).  The port of
``repro/models/common.py`` (M-RoPE, layer norm and the GELU MLP wait for
the families that use them).

Rounding follows the reference: ``rms_norm`` takes f32 statistics but
normalises in x's type, and ``apply_rope`` rotates in f32 and casts back.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down(silu(x @ gate) * (x @ up)); weights (in, out)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies in f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, rotate-half convention.

    x: (..., S, H, hd); positions: broadcastable to (..., S) integers.
    """
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    ang = positions[..., :, None].float() * inv              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass
class InitCtx:
    """Draws parameters from one explicitly seeded ``torch.Generator``,
    in call order, on the generator's device.

    The scales are the reference's (``InitCtx.make``): ``fan_in`` is
    1/√(input width), ``embed`` is 1.0, a number is taken as the std.  The
    bits are not: ``jax.random`` and torch generators differ, so parity
    tests carry the JAX weights across (``interop.lm_params_from_numpy``).
    One difference in the scale: the JAX package makes a layer's weight
    inside its (L, ...) stack, so its ``fan_in`` reads the layer count;
    the port makes each layer's weight alone and reads its input width.
    """

    generator: torch.Generator
    dtype: torch.dtype = torch.bfloat16

    def make(self, shape: tuple[int, ...], *,
             scale: str | float = "fan_in", zero: bool = False) -> torch.Tensor:
        if zero:
            return torch.zeros(shape, dtype=self.dtype,
                               device=self.generator.device)
        if scale == "fan_in":
            std = 1.0 / math.sqrt(shape[0] if len(shape) >= 2 else shape[-1])
        elif scale == "embed":
            std = 1.0
        else:
            std = float(scale)
        w = torch.randn(shape, generator=self.generator,
                        device=self.generator.device, dtype=torch.float32)
        return (w * std).to(self.dtype)

    def const(self, value: torch.Tensor) -> torch.Tensor:
        """A parameter with a fixed initial value (an SSM's ``A_log``,
        ``D``, ``dt_bias``), on the generator's device.  It keeps its own
        dtype (f32 for those three), not the parameter dtype, as in the
        reference."""
        return value.to(self.generator.device)
