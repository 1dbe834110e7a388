"""The port's model stack: dense GQA decoder-only LMs (granite-3-2b) and
Mamba-2 SSM LMs (mamba2-1.3b)."""

from .model import Model

__all__ = ["Model"]
