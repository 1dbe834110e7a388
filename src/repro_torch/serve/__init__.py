"""Serving on the port's model stack."""

from .engine import ServeEngine

__all__ = ["ServeEngine"]
