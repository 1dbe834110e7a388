"""Build ``csrc/selective_scan.cu`` (``kernels/nvcc.py``) and load it
with ``ctypes``."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    return nvcc.build(SOURCE)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library, typed."""
    return typed(ctypes.CDLL(str(build())))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with its one entry point typed (pointers and the stream as
    ``c_void_p``, strides as ``c_longlong``)."""
    fn = lib.selective_scan
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
