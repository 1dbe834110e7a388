"""Flow Imbalance Metric (paper eq. 1) and the throughput model used to
reproduce Fig. 3(a).

FIM = (100/n) * sum_i |actual_i - ideal_i| / ideal_i       (MAPE)

where i ranges over the network links of the fabric (optionally restricted
to one layer, as in the paper's per-layer subplots) and ideal_i is the
perfectly balanced per-link count.  Lower is better; 0 means every link
carries exactly the balanced share.

The throughput model is progressive-filling max-min fairness over link
capacities: each flow's rate is limited by its most contended link, which
is precisely how colliding 100G RoCE flows halve each other (paper
Section I).  Per-pair throughput is the sum over the pair's flows.

The port's own copy of ``repro.core.fim`` (the port imports nothing of
``repro``); keep the two in step.  These are the scalar Path Analyzer
metrics over traced paths (``FlowTracer``, ``static_route_assignment``,
``VectorTraceResult.paths_for_seed``): host Python whose float
operations run in the reference's order, so values are equal, not just
close.  The tensor versions over a whole seed sweep are
``vector_sim.fim_vector`` and ``vector_throughput.max_min_rates``.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from collections.abc import Mapping, Sequence

from .fabric import Fabric, Link
from .flows import Flow

# A traced path is the ordered list of links a flow traverses.
Path = list[Link]


def link_flow_counts(paths: Mapping[int, Path]) -> dict[str, int]:
    """actual_flows_i for every link that appears in any path."""
    counts: dict[str, int] = defaultdict(int)
    for path in paths.values():
        for link in path:
            counts[link.name] += 1
    return dict(counts)


def fim(
    paths: Mapping[int, Path],
    fabric: Fabric,
    *,
    layers: Sequence[str] | None = None,
    only_used_leaves: bool = False,
) -> float:
    """Flow Imbalance Metric over the links of ``layers`` (default: every
    layer that carries at least one flow somewhere in the fabric).

    ``ideal_flows_i`` is total flows on the layer / number of links in the
    layer — the paper's "each link carries an equal number of flows".
    Links in layers that carry zero total flows are excluded (ideal would
    be 0 and MAPE undefined); that matches the paper's use, where only the
    layers exercised by the workload are plotted.
    """
    values = per_layer_fim(paths, fabric, layers=layers,
                           only_used_leaves=only_used_leaves)
    if not values:
        return 0.0
    # Aggregate FIM = mean over all participating links, i.e. weight each
    # layer by its link count.
    total_links = sum(n for _, n in values.values())
    if total_links == 0:
        return 0.0
    return sum(v * n for v, n in values.values()) / total_links


@dataclasses.dataclass(frozen=True)
class LayerLoadStats:
    """One layer's link-load aggregate — the single source both the FIM
    computations and the path report (core/report.py) read, so per-link
    counts, totals, ideals, and MAPE can never drift apart."""

    link_counts: dict[str, int]   # every participating link, incl. idle
    total: int                    # sum of counts over the layer
    n_links: int
    ideal: float                  # total / n_links
    fim_pct: float                # MAPE over the layer's links


def layer_load_stats(
    paths: Mapping[int, Path],
    fabric: Fabric,
    *,
    layers: Sequence[str] | None = None,
    only_used_leaves: bool = False,
) -> dict[str, LayerLoadStats]:
    """Per-layer load stats.  Layers with zero traffic are dropped, and
    so are *empty* layers (no links — after the ``only_used_leaves``
    filter an exercised layer can end up linkless): their ideal load is
    undefined, so they are skipped rather than divided by zero."""
    counts = link_flow_counts(paths)
    used_devs: set[str] = set()
    if only_used_leaves:
        for p in paths.values():
            for l in p:
                used_devs.add(l.src)
                used_devs.add(l.dst)
    out: dict[str, LayerLoadStats] = {}
    for layer in (layers or fabric.layers):
        links = fabric.links_by_layer(layer)
        if only_used_leaves:
            links = [l for l in links if l.src in used_devs and l.dst in used_devs]
        if not links:
            continue
        per_link = {l.name: counts.get(l.name, 0) for l in links}
        total = sum(per_link.values())
        if total == 0:
            continue
        ideal = total / len(links)
        mape = 100.0 / len(links) * sum(
            abs(c - ideal) / ideal for c in per_link.values()
        )
        out[layer] = LayerLoadStats(link_counts=per_link, total=total,
                                    n_links=len(links), ideal=ideal,
                                    fim_pct=mape)
    return out


def per_layer_fim(
    paths: Mapping[int, Path],
    fabric: Fabric,
    *,
    layers: Sequence[str] | None = None,
    only_used_leaves: bool = False,
) -> dict[str, tuple[float, int]]:
    """Per-layer (FIM, n_links).  Layers with zero traffic are dropped."""
    stats = layer_load_stats(paths, fabric, layers=layers,
                             only_used_leaves=only_used_leaves)
    return {layer: (s.fim_pct, s.n_links) for layer, s in stats.items()}


def max_min_throughput(paths: Mapping[int, Path]) -> dict[int, float]:
    """Progressive-filling max-min fair rates (Gb/s) per flow id.

    Iteratively saturate the tightest link: rate = residual capacity /
    unfrozen flows crossing it; freeze those flows; repeat.  Exact for the
    single-path, equal-demand case the paper evaluates.

    This is the readable scalar reference the vectorized engine
    (``core/vector_throughput.py``) is differentially tested against.
    The bottleneck is found with a lazy-invalidation heap: stale entries
    (their share no longer matches the link's current residual/count) are
    skipped on pop, and a link is re-pushed whenever a freeze drains it.
    """
    link_cap: dict[str, float] = {}
    link_flows: dict[str, set[int]] = defaultdict(set)
    for fid, path in paths.items():
        for link in path:
            link_cap[link.name] = link.gbps
            link_flows[link.name].add(fid)

    rate: dict[int, float] = {}
    active: set[int] = set(paths.keys())
    residual = dict(link_cap)
    live_flows = {k: set(v) for k, v in link_flows.items()}
    heap = [(residual[name] / len(fl), name)
            for name, fl in live_flows.items() if fl]
    heapq.heapify(heap)
    while active:
        # bottleneck link = min residual/active_flows among links w/ active flows
        best_link = None
        while heap:
            share, name = heapq.heappop(heap)
            fl = live_flows[name]
            if fl and share == residual[name] / len(fl):
                best_link, best_share = name, share
                break
        if best_link is None:
            for fid in active:
                rate[fid] = float("inf")
            break
        drained: set[str] = set()
        for fid in list(live_flows[best_link]):
            rate[fid] = best_share
            active.discard(fid)
            for path_link in paths[fid]:
                if fid in live_flows[path_link.name]:
                    live_flows[path_link.name].discard(fid)
                    residual[path_link.name] -= best_share
                    drained.add(path_link.name)
        live_flows[best_link].clear()
        for name in drained:
            fl = live_flows[name]
            if fl:
                heapq.heappush(heap, (residual[name] / len(fl), name))
    return rate


def per_pair_throughput(
    flows_list: Sequence[Flow], paths: Mapping[int, Path]
) -> dict[tuple[str, str], float]:
    rates = max_min_throughput(paths)
    out: dict[tuple[str, str], float] = defaultdict(float)
    for f in flows_list:
        out[(f.src, f.dst)] += rates.get(f.flow_id, 0.0)
    return dict(out)
