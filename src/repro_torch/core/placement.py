"""Preprogrammed routing + topology-aware placement.

``static_route_assignment`` automates the paper's second configuration
("a preprogrammed static routing configuration, which promotes the
selection of distinct paths across the different communication pairs"):
instead of hand-programming switch tables, we walk every flow through the
fabric and at each multi-choice hop pick the least-loaded equal-cost
egress link (ties broken deterministically).  The result is a
(device, flow) -> egress-port table consumable by ``StaticRouting``.

Beyond the paper (§V future work: "dynamic routing adjustments"), this
module also optimizes the *traffic itself*:

* ``topology_aware_ring``   — reorder a collective ring so consecutive
  devices share a host, then a pod: inter-pod DCN edges drop from O(n) to
  the theoretical minimum (2 per pod boundary pair).
* ``balanced_port_spread``  — assign the per-edge flows of a collective to
  NIC ports/uplinks round-robin, the static analogue for DCN flows.

The port's own copy of ``repro.core.placement`` (the port imports nothing
of ``repro``); keep the two in step.  It is host Python, an operator's
offline planning step.  Not to be confused with ``kernels/placement``,
the CUDA kernel of the congestion-aware strategies' sequential chain
(``core/strategies.py``), which places flows of a Monte-Carlo sweep on
the card.
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Mapping, Sequence

from .ecmp import Forwarder
from .fabric import Fabric, Link, SERVER
from .flows import Flow

Path = list[Link]


def _interleave_by_pair(flows: Sequence[Flow]) -> list[Flow]:
    by_pair: dict[tuple[str, str], list[Flow]] = defaultdict(list)
    for f in flows:
        by_pair[(f.src, f.dst)].append(f)
    ordered: list[Flow] = []
    queues = list(by_pair.values())
    i = 0
    while any(queues):
        q = queues[i % len(queues)]
        if q:
            ordered.append(q.pop(0))
        i += 1
    return ordered


def enumerate_paths(fabric: Fabric, fwd: Forwarder, flow: Flow,
                    max_paths: int = 4096) -> list[Path]:
    """All equal-cost end-to-end paths for a flow (DFS over the per-hop
    candidate sets)."""
    out: list[Path] = []
    stack: list[tuple[str, Path]] = [(flow.src, [])]
    while stack and len(out) < max_paths:
        device, prefix = stack.pop()
        for link in fwd.candidates(device, flow):
            path = prefix + [link]
            if fabric.kind(link.dst) == SERVER:
                out.append(path)
            else:
                stack.append((link.dst, path))
    return out


def static_route_assignment(
    fabric: Fabric,
    flows: Sequence[Flow],
    *,
    mode: str = "minmax",
) -> tuple[dict[tuple[str, int], str], dict[int, Path]]:
    """Compute the paper's "preprogrammed static routing" automatically.

    ``minmax`` (default): for each flow (pair-interleaved order), enumerate
    its equal-cost paths and pick the one minimizing (max link load along
    the path, then total load, then name) — destination-aware, so it
    balances *every* layer including spine->leaf downlinks, which a
    per-hop greedy cannot see.  ``hop_greedy`` is the cheaper per-hop
    variant for very large flow sets.

    Returns the static table {(device, flow_id): egress port} — exactly
    what an operator would preprogram into each device — plus the paths.
    """
    fwd = Forwarder(fabric)
    load: dict[str, int] = defaultdict(int)
    table: dict[tuple[str, int], str] = {}
    paths: dict[int, Path] = {}
    ordered = _interleave_by_pair(flows)

    for flow in ordered:
        if mode == "minmax":
            cands = enumerate_paths(fabric, fwd, flow)
            path = min(
                cands,
                key=lambda p: (
                    max(load[l.name] + 1 for l in p),
                    sum(load[l.name] for l in p),
                    tuple(l.name for l in p),
                ),
            )
        elif mode == "hop_greedy":
            path = []
            device = flow.src
            for _ in range(32):
                hop_cands = fwd.candidates(device, flow)
                link = min(hop_cands, key=lambda l: (load[l.name], l.name))
                path.append(link)
                if fabric.kind(link.dst) == SERVER:
                    break
                device = link.dst
        else:
            raise ValueError(mode)
        for link in path:
            load[link.name] += 1
            src_dev = link.src
            if len(fwd.candidates(src_dev, flow)) > 1:
                table[(src_dev, flow.flow_id)] = link.src_port
        paths[flow.flow_id] = path
    return table, paths


# ---------------------------------------------------------------------------
# Beyond-paper: collective-aware placement
# ---------------------------------------------------------------------------


def topology_aware_ring(
    group: Sequence[int], coords: Mapping[int, tuple[int, int, int]]
) -> list[int]:
    """Reorder a replica group so ring neighbours are topologically close.

    ``coords[d] = (pod, host, chip)``.  Sorting lexicographically makes all
    intra-host hops adjacent, then intra-pod, leaving exactly one
    pod-crossing edge per pod boundary (plus the wrap-around) — the minimum
    any ring can achieve.
    """
    return sorted(group, key=lambda d: coords[d])


def ring_edge_stats(
    group: Sequence[int], coords: Mapping[int, tuple[int, int, int]]
) -> dict[str, int]:
    """Count ring edges by locality class (chip/host/pod crossing)."""
    stats = {"intra_host": 0, "intra_pod": 0, "inter_pod": 0}
    n = len(group)
    for i in range(n):
        a, b = coords[group[i]], coords[group[(i + 1) % n]]
        if a[0] != b[0]:
            stats["inter_pod"] += 1
        elif a[1] != b[1]:
            stats["intra_pod"] += 1
        else:
            stats["intra_host"] += 1
    return stats


def balanced_port_spread(num_flows: int, num_ports: int) -> list[int]:
    """Static round-robin of flows onto ports (a 1-hop static table)."""
    return [i % num_ports for i in range(num_flows)]
