"""FlowTracer's Monte-Carlo path simulator on PyTorch and CUDA.

The port of the JAX package ``repro`` to one NVIDIA H100, slice by
slice; ``repro`` stays the reference.  This package imports ``torch``
and never ``jax`` or anything of ``repro``: it keeps its own copies of
the pure-Python modules it needs.  Entry points run on the card unless
the caller passes ``device="cpu"`` (``repro_torch.device``).
"""

from .device import generator, resolve_device

__all__ = ["generator", "resolve_device"]
