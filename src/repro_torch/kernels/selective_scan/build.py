"""Build ``csrc/selective_scan.cu`` (``kernels/nvcc.py``) and load it
with ``ctypes``."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"


#: the macro that builds the backward as a probe of its exponentials: each
#: lane's first state of dA then holds the exponentials the lane took
#: (summed over batch rows), its other states 0
COUNT_EXP = "SCAN_BWD_COUNT_EXP"


def build(*defines: str) -> Path:
    """Compile the library, with the macros ``defines`` defined, unless
    that build of this source already exists."""
    return nvcc.build(SOURCE, defines)


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
    ``selective_scan_bwd``, ``selective_scan_blocks_per_sm(bf16,
    aligned)`` and ``selective_scan_bwd_blocks_per_sm`` likewise,
    ``selective_scan_bwd_scratch(B, S, D, N, floats)`` and
    ``selective_scan_bwd_threads()``."""
    fn = lib.selective_scan
    fn.argtypes, fn.restype = SCAN_ARGTYPES, ctypes.c_int
    bwd = lib.selective_scan_bwd
    bwd.argtypes, bwd.restype = BWD_ARGTYPES, ctypes.c_int
    for occ in (lib.selective_scan_blocks_per_sm,
                lib.selective_scan_bwd_blocks_per_sm):
        occ.argtypes, occ.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    lib.selective_scan_bwd_scratch.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.selective_scan_bwd_scratch.restype = None
    lib.selective_scan_bwd_threads.argtypes = []
    lib.selective_scan_bwd_threads.restype = ctypes.c_int
    return lib
