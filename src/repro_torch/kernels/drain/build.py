"""Build ``csrc/drain.cu`` (``kernels/nvcc.py``) and load it with
``ctypes``."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "drain.cu"


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    return nvcc.build(SOURCE)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its one entry point typed (every pointer
    and the stream as ``c_void_p``, which ctypes would otherwise cut to
    32 bits)."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.departure_drain
    p = ctypes.c_void_p
    fn.argtypes = [p] * 13 + [ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return lib
