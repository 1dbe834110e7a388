"""Build ``csrc/loads.cu`` (``kernels/nvcc.py``) and load it with
``ctypes``."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "loads.cu"

#: the argument types of ``ordered_cell_sum`` in every build of the source
#: (every pointer and the stream as ``c_void_p``, which ctypes would
#: otherwise cut to 32 bits)
SUM_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
                + [ctypes.c_int, ctypes.c_void_p])


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    return nvcc.build(SOURCE)


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with its two entry points typed: the ordered sum and the
    float64 add latency probe."""
    lib.ordered_cell_sum.argtypes = SUM_ARGTYPES
    lib.ordered_cell_sum.restype = ctypes.c_int
    lib.dadd_latency_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.dadd_latency_probe.restype = ctypes.c_int
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The built library, typed."""
    return typed(ctypes.CDLL(str(build())))
