"""Elastic scaling + failure handling.

On a real pod, a host failure surfaces as missing devices at restart (or
a collective timeout mid-run).  The recovery path implemented here:

  1. ``plan_elastic_mesh``: from the surviving device count, choose the
     largest usable (data, model) grid compatible with the model's TP
     requirement, and the new per-host batch slice (global batch is
     preserved by increasing per-device batch or grad-accum).
  2. restore the latest checkpoint (host-side numpy, mesh-agnostic) with
     the new shardings;
  3. resume from the step recorded in the checkpoint — the step-indexed
     data pipeline replays the exact stream.

``run_with_restarts`` wires this into a training loop; the tests drive
it with injected failures.  The port's copy of ``repro/ft/elastic.py``
(plain Python).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    grad_accum_multiplier: int      # to preserve global batch
    dropped_devices: int


def plan_elastic_mesh(
    num_devices: int,
    *,
    model_parallel: int,
    prefer_data: int | None = None,
    axis_names: tuple[str, str] = ("data", "model"),
) -> ElasticPlan:
    """Largest (data, model) grid from surviving devices.

    model_parallel is fixed by the weight shardings (TP degree must match
    the checkpoint layout for cheap restarts); the data axis absorbs the
    loss.  Any remainder devices idle until the next maintenance window —
    the standard trade on real pods.
    """
    if num_devices < model_parallel:
        raise ValueError(
            f"{num_devices} devices cannot host model_parallel={model_parallel}")
    data = num_devices // model_parallel
    if prefer_data:
        data = min(data, prefer_data)
    used = data * model_parallel
    # preserve global batch: if data axis shrank by k, accumulate k more
    mult = 1
    if prefer_data and data < prefer_data:
        mult = math.ceil(prefer_data / data)
    return ElasticPlan(
        mesh_shape=(data, model_parallel),
        axis_names=axis_names,
        grad_accum_multiplier=mult,
        dropped_devices=num_devices - used,
    )


class HostFailure(RuntimeError):
    """Simulated/detected loss of a host (collective timeout, ICI error)."""


def run_with_restarts(
    train_loop: Callable[[int], int],
    *,
    max_restarts: int = 3,
    on_restart: Callable[[int], None] | None = None,
) -> int:
    """Run ``train_loop(start_step) -> final_step``; on HostFailure,
    invoke ``on_restart`` (re-mesh + restore) and continue."""
    restarts = 0
    step = 0
    while True:
        try:
            return train_loop(step)
        except HostFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts)
            # train_loop re-reads the checkpoint to find its resume step
            step = -1
