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


#: ``selective_scan``'s argument types: pointers and the stream as
#: ``c_void_p``, sizes as ``c_int``, strides as ``c_longlong``
SCAN_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])


#: ``selective_scan_bwd``'s: sixteen pointers, five sizes, eight strides
#: and the stream
BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with its entry points typed: ``selective_scan``,
    ``selective_scan_bwd`` and ``selective_scan_blocks_per_sm(bf16,
    aligned)``."""
    fn = lib.selective_scan
    fn.argtypes, fn.restype = SCAN_ARGTYPES, ctypes.c_int
    bwd = lib.selective_scan_bwd
    bwd.argtypes, bwd.restype = BWD_ARGTYPES, ctypes.c_int
    occ = lib.selective_scan_blocks_per_sm
    occ.argtypes, occ.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return lib
