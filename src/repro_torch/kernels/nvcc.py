"""Build a kernel family's CUDA source with ``nvcc`` into a plain C
shared library, for ``ctypes``.

The libraries have plain C interfaces (no PyTorch headers), so each
builds in seconds.  A library is built at first use from the checkout's
own source into ``_build/`` beside its family's package, under a name
keyed by a hash of the source, the headers it includes with ``#include
"..."`` (``kernels/csrc/hopper.cuh``), the flags and any macros defined
for a probe build, so an edited source or header is never served a stale
library.  The compiler's register and spill report
(``-Xptxas -v``) is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin); the port's kernels are built from source at "
        "first use on the card")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(source: Path) -> list[Path]:
    """``source`` and every file it includes with ``#include "..."``,
    transitively, each resolved against the including file's directory
    (as ``nvcc`` resolves them) and listed once."""
    seen: list[Path] = []
    todo = [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [(path.parent / name.decode()).resolve()
                 for name in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(source: Path, defines: tuple[str, ...] = ()) -> Path:
    """Where the library for ``source`` (``<family>/csrc/<name>.cu``), the
    headers it includes, the current flags and the macros ``defines``
    lives: ``<family>/_build/<name>-<hash>.so``."""
    digest = hashlib.sha256()
    for path in sources(source):
        digest.update(path.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    key = digest.hexdigest()[:16]
    return source.parent.parent / "_build" / f"{source.stem}-{key}.so"


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{name}" for name in defines)


def build(source: Path, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``source``, with the macros ``defines`` defined, unless
    that build already exists."""
    out = library_path(source, defines)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *_flags(defines), "-o", str(tmp), str(source)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n"
            f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)                  # atomic: readers never see half
    return out
