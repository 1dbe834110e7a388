"""Build ``csrc/flowhash.cu`` (``kernels/nvcc.py``) and load it with
``ctypes``."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flowhash.cu"


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    return nvcc.build(SOURCE)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its one entry point typed.  Every pointer
    and the stream are ``c_void_p``: left untyped, ctypes would pass them
    as 32-bit ints and cut them."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.flowhash_grid
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
