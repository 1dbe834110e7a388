"""Straggler detection & mitigation.

On multi-pod runs a slow host (thermal throttle, failing NIC, ECMP
collision victim — exactly what FlowTracer diagnoses) drags every
synchronous step.  This module provides the detection half and the
mitigation hooks:

  * ``StragglerDetector``: per-host EWMA of step durations; a host whose
    EWMA exceeds ``threshold`` x the fleet median is flagged.
  * mitigation hooks: (a) report the flagged host + its traffic to
    FlowTracer for path analysis (is it an ECMP collision? -> repath);
    (b) advise dropping the host (elastic re-mesh); (c) advise
    microbatch rebalancing (shrink the slow host's shard).

The detector is pure logic (unit-tested with synthetic timings); the
launcher wires it to real step timings.  The port's copy of
``repro/ft/straggler.py``.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict


@dataclasses.dataclass
class StragglerReport:
    host: str
    ewma_s: float
    median_s: float
    ratio: float
    advice: str


class StragglerDetector:
    def __init__(self, *, alpha: float = 0.3, threshold: float = 1.5,
                 min_samples: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self._ewma: dict[str, float] = {}
        self._count: dict[str, int] = defaultdict(int)

    def record(self, host: str, step_seconds: float) -> None:
        prev = self._ewma.get(host)
        self._ewma[host] = (step_seconds if prev is None
                            else self.alpha * step_seconds + (1 - self.alpha) * prev)
        self._count[host] += 1

    def check(self) -> list[StragglerReport]:
        ready = {h: v for h, v in self._ewma.items()
                 if self._count[h] >= self.min_samples}
        if len(ready) < 2:
            return []
        med = statistics.median(ready.values())
        out = []
        for host, ewma in sorted(ready.items()):
            ratio = ewma / max(med, 1e-9)
            if ratio >= self.threshold:
                advice = ("trace-paths" if ratio < 2.0 else
                          "rebalance" if ratio < 3.0 else "evict")
                out.append(StragglerReport(host, ewma, med, ratio, advice))
        return out
