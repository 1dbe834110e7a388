"""Build ``csrc/placement.cu`` (``kernels/nvcc.py``) and load it with
``ctypes``."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "placement.cu"


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    return nvcc.build(SOURCE)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its two entry points typed (every pointer
    and the stream as ``c_void_p``, which ctypes would otherwise cut to
    32 bits): the placement chain and the shared-memory latency probe."""
    lib = ctypes.CDLL(str(build()))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.congestion_place
    fn.argtypes = ([p] + [ll] * 6 + [i] * 3 + [p, i] + [p] * 10
                   + [ll] * 4 + [i, i, p])
    fn.restype = ctypes.c_int
    probe = lib.smem_latency_probe
    probe.argtypes = [p, i, p]
    probe.restype = ctypes.c_int
    return lib
