"""Build ``csrc/flowhash.cu`` with ``nvcc`` and load it with ``ctypes``.

The shared library has a plain C interface (no PyTorch headers), so it
builds in seconds.  It is built at first use from the checkout's own
source into ``_build/`` beside this file, under a name keyed by a hash of
the source and the flags, so an edited source is never served a stale
library.  The compiler's register and spill report (``-Xptxas -v``) is
kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "flowhash.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin); the flow-hash kernel is built from source "
        "at first use on the card")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"flowhash-{key}.so"


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
            f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)                  # atomic: readers never see half
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its one entry point typed.  Every pointer
    and the stream are ``c_void_p``: left untyped, ctypes would pass them
    as 32-bit ints and cut them."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.flowhash_grid
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
