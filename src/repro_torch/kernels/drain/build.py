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
    """The built library with its entry points typed (every pointer and
    the stream as ``c_void_p``, which ctypes would otherwise cut to 32
    bits): the drain, the width of its statistics rows, the clusters of a
    launch shape the card keeps resident and the cluster-reduction
    probe."""
    return typed(ctypes.CDLL(str(build())))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s entry points typed (any build of ``drain.cu``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.departure_drain
    fn.argtypes = ([p] * 12 + [ctypes.c_longlong, ctypes.c_double]
                  + [i] * 5 + [p])
    fn.restype = ctypes.c_int
    lib.drain_stats_cols.argtypes = []
    lib.drain_stats_cols.restype = i
    lib.drain_resident_clusters.argtypes = [i] * 4 + [p]
    lib.drain_resident_clusters.restype = i
    probe = lib.drain_sync_probe
    probe.argtypes = [i] * 5 + [p, p]
    probe.restype = i
    return lib
