"""Path Analyzer (paper Steps 6-7): compile traced paths into the final,
easy-to-consume output — per-layer link-load tables, FIM, collision list.

The port's own copy of ``repro.core.report`` (the port imports nothing of
``repro``); keep the two in step.
"""

from __future__ import annotations

import dataclasses
import json
from collections.abc import Mapping, Sequence

from .fabric import Fabric, Link
from .fim import fim, layer_load_stats

Path = list[Link]


@dataclasses.dataclass
class PathReport:
    total_flows: int
    per_layer: dict[str, dict[str, int]]      # layer -> link name -> count
    per_layer_fim: dict[str, float]           # layer -> FIM %
    aggregate_fim: float
    collisions: list[tuple[str, int]]         # links above ideal, worst first
    ideal_per_layer: dict[str, float]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def summary(self) -> str:
        lines = [f"FlowTracer report: {self.total_flows} flows traced"]
        for layer, lf in self.per_layer_fim.items():
            ideal = self.ideal_per_layer[layer]
            lines.append(f"  [{layer:14s}] FIM = {lf:6.2f}%  (ideal {ideal:.2f} flows/link)")
        lines.append(f"  aggregate FIM = {self.aggregate_fim:.2f}%")
        if self.collisions:
            worst = ", ".join(f"{n}={c}" for n, c in self.collisions[:5])
            lines.append(f"  worst links: {worst}")
        return "\n".join(lines)


def analyze_paths(
    paths: Mapping[int, Path],
    fabric: Fabric,
    *,
    layers: Sequence[str] | None = None,
) -> PathReport:
    # one layer_load_stats pass carries the per-link counts, totals,
    # ideals, and FIM together (fim.py is the single source; empty
    # layers are guarded there), so the report cannot disagree with the
    # metric it annotates
    stats = layer_load_stats(paths, fabric, layers=layers)

    collisions = [
        (name, c)
        for s in stats.values()
        for name, c in s.link_counts.items()
        if c > s.ideal
    ]
    collisions.sort(key=lambda x: -x[1])

    return PathReport(
        total_flows=len(paths),
        per_layer={k: dict(s.link_counts) for k, s in stats.items()},
        per_layer_fim={k: s.fim_pct for k, s in stats.items()},
        aggregate_fim=fim(paths, fabric, layers=layers),
        collisions=collisions,
        ideal_per_layer={k: s.ideal for k, s in stats.items()},
    )
