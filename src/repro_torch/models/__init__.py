"""The port's model stack: dense GQA decoder-only LMs (granite-3-2b)."""

from .model import Model

__all__ = ["Model"]
