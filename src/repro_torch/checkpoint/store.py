"""Checkpointing: atomic, step-indexed, resumable.  The port of
``repro/checkpoint/store.py``.

Layout:
    <dir>/step_<N>/arrays.pt       every leaf of the tree, on the host
    <dir>/step_<N>/meta.json       step, leaf paths, dtypes and shapes
    <dir>/LATEST                   text file with the newest step

Writes go to ``step_<N>.tmp`` and are published by ``os.replace``
(atomic on POSIX), and ``LATEST`` is swapped the same way, so a failure
mid-write never corrupts the restore point.  Leaves are stored on the
host by ``torch.save`` of a flat {path: tensor} dict and read back with
``torch.load(weights_only=True)``: each dtype, bfloat16 included, comes
back bit for bit, and ``restore`` puts the tree on any device.  (The
reference packs with ``msgpack``, which the port does not need.)
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from ..device import resolve_device
from ..tree import leaves, paths, rebuild

ARRAYS = "arrays.pt"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree: Any, *, keep_last: int = 3) -> str:
    """Write ``tree`` (nested dicts and lists of tensors) as step
    ``step``, make it ``LATEST`` and keep the newest ``keep_last``
    steps.  Returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    keys = paths(tree)
    flat = {k: torch.as_tensor(v).detach().to("cpu").contiguous()
            for k, v in zip(keys, leaves(tree))}
    torch.save(flat, os.path.join(tmp, ARRAYS))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat),
                   "dtypes": {k: str(v.dtype) for k, v in flat.items()},
                   "shapes": {k: list(v.shape) for k, v in flat.items()}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))

    _gc(directory, keep_last)
    return final


def _gc(directory: str, keep_last: int) -> None:
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(directory: str, template: Any, *, step: int | None = None,
            device=None) -> tuple[Any, int]:
    """Restore into the structure of ``template`` (nested dicts and lists
    of tensors, whose dtypes the leaves take) on ``device`` (the card
    unless ``"cpu"``).  Returns (tree, step)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    flat = torch.load(os.path.join(_step_dir(directory, step), ARRAYS),
                      map_location="cpu", weights_only=True)
    out = []
    for key, want in zip(paths(template), leaves(template)):
        if key not in flat:
            raise KeyError(f"checkpoint step {step} has no leaf {key!r}")
        out.append(flat[key].to(device=dev, dtype=want.dtype))
    return rebuild(template, out), step
