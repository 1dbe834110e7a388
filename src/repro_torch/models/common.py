"""Shared model components: RMSNorm, layer norm, the SwiGLU and GELU
MLPs, rotary embeddings (1-D and Qwen2-VL's M-RoPE) and the initializer
(random, zero and constant parameters).  The port of
``repro/models/common.py``, with ``count_params``.

Rounding follows the reference: ``rms_norm`` and ``layer_norm`` take f32
statistics but normalise in x's type (``F.layer_norm`` would normalise
in f32 and round once), a bias is added to a product already rounded to
x's type, and ``apply_rope`` rotates in f32 and casts back.
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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Two-pass layer norm: f32 row mean, ``d = x - mu`` in x's type, f32
    variance of d, then ``d * inv * scale + bias`` in x's type."""
    mu = x.float().mean(dim=-1, keepdim=True)
    d = x - mu.to(x.dtype)
    var = d.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return d * inv * scale.to(x.dtype) + bias.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down(silu(x @ gate) * (x @ up)); weights (in, out)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """Tanh-GELU MLP: gelu(x @ w_in + b_in) @ w_out + b_out, each bias
    added after its product rounds to x's type (not a fused epilogue)."""
    h = F.gelu((x @ w_in) + b_in, approximate="tanh")
    return (h @ w_out) + b_out


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies in f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of ``apply_rope`` at ``positions``, each (..., S, 1,
    hd) in f32, laid out for the whole head: cos twice, and -sin then
    sin.  A forward computes them once for all its layers."""
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    ang = positions[..., :, None].float() * inv              # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], dim=-1)[..., None, :],
            torch.cat([-sin, sin], dim=-1)[..., None, :])


def mrope_tables(positions: torch.Tensor, sections: tuple[int, ...],
                 head_dim: int, theta: float = 1000000.0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_tables`` for M-RoPE (Qwen2-VL): the rotary half-dims are cut
    into ``sections`` (temporal, height, width), each turned by its own
    stream of ``positions`` (3, B, S).  Returns (cos, sin), each (B, S,
    1, hd) in f32, in ``rope_tables``' layout, for ``apply_rope``."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {head_dim // 2}")
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    stream = torch.repeat_interleave(
        torch.arange(len(sections), device=positions.device),
        torch.tensor(sections, device=positions.device))     # (hd/2,)
    pos = positions.float()[stream]                          # (hd/2, B, S)
    ang = pos.movedim(0, -1) * inv                           # (B, S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], dim=-1)[..., None, :],
            torch.cat([-sin, sin], dim=-1)[..., None, :])


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...], theta: float = 1000000.0, *,
                tables: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Multimodal RoPE.  x: (B, S, H, hd); positions: (3, B, S);
    ``tables``: ``mrope_tables`` of these positions, where computed
    once for all layers."""
    if tables is None:
        tables = mrope_tables(positions, sections, x.shape[-1], theta)
    return apply_rope(x, positions, theta, tables=tables)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, *,
               tables: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> torch.Tensor:
    """Rotary position embedding, rotate-half convention.

    x: (..., S, H, hd); positions: broadcastable to (..., S) integers;
    ``tables``: ``rope_tables`` of these positions, where computed once.
    The halves are [x1 cos - x2 sin, x2 cos + x1 sin] in f32, each
    term rounded as the reference rounds it (a - b is a + (-b) exactly).
    """
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], theta)
    cos, sin = tables
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = xf * cos + torch.cat([x2, x1], dim=-1) * sin
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


def count_params(params) -> int:
    """Number of parameters in a nested dict / list of tensors."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()
