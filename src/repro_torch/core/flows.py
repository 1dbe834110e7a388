"""Flow primitives: 5-tuples, flows, and workload descriptions.

The port's own copy of ``repro.core.flows`` (the port imports nothing of
``repro``); keep the two in step.

Mirrors the paper's Step (1): the *workload description* names the exact
server pairs involved in the communication and the number of flows ``f``
between each pair.  Flows are identified by the RoCEv2/TCP 5-tuple
(src_ip, dst_ip, src_port, dst_port, protocol).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Iterable, Sequence

PROTO_TCP = 6
PROTO_UDP = 17
# RoCEv2 rides UDP/4791; we keep the inner QP pair in the port fields the
# way the NIC exposes it (paper Section III-B.1b).
ROCE_UDP_DPORT = 4791


@dataclasses.dataclass(frozen=True, slots=True)
class FiveTuple:
    """The classic flow identity used for every ECMP hash decision."""

    src_ip: str
    dst_ip: str
    src_port: int
    dst_port: int
    protocol: int = PROTO_UDP

    def as_key(self) -> tuple[str, str, int, int, int]:
        return (self.src_ip, self.dst_ip, self.src_port, self.dst_port, self.protocol)


@dataclasses.dataclass(frozen=True, slots=True)
class Flow:
    """A unidirectional flow between two endpoints.

    ``src``/``dst`` are *server* names (fabric node ids); the 5-tuple binds
    the flow to concrete NIC IPs so hash decisions are reproducible.
    ``bytes`` carries the volume for throughput / roofline analysis (0 for
    pure path-discovery runs, where only counts matter).
    """

    flow_id: int
    src: str
    dst: str
    tuple5: FiveTuple
    bytes: int = 0
    label: str = ""  # e.g. the HLO collective op this flow came from


@dataclasses.dataclass(frozen=True, slots=True)
class PairSpec:
    """One (s, d) communication pair with ``f`` flows (paper Alg. 1 input).

    ``bytes_per_flow`` optionally pins the volume of this pair's flows:
    the paper's workload description names flow *volumes* as well as
    pairs, and real LLM collectives are heavily non-uniform (a DP
    gradient all-reduce is ~9 orders of magnitude heavier than a
    barrier).  ``None`` defers to the ``synthesize_flows`` default.
    """

    src: str
    dst: str
    num_flows: int
    bytes_per_flow: int | None = None


@dataclasses.dataclass(slots=True)
class WorkloadDescription:
    """Paper Step (1): server pairs + flows per pair (+ filter info)."""

    pairs: list[PairSpec]
    filter_protocols: tuple[int, ...] = (PROTO_TCP, PROTO_UDP)

    @property
    def total_flows(self) -> int:
        return sum(p.num_flows for p in self.pairs)

    @property
    def total_bytes(self) -> int:
        """Declared volume over all pairs.  Pairs without an explicit
        ``bytes_per_flow`` spec count as 0 — the description only knows
        what it declares (a synthesize-time default is not visible here)."""
        return sum(p.num_flows * (p.bytes_per_flow or 0) for p in self.pairs)

    def filter(self, flows: Iterable[Flow]) -> list[Flow]:
        """Keep only flows relevant to this workload (paper Alg. 1 line 7)."""
        wanted = {(p.src, p.dst) for p in self.pairs}
        return [
            f
            for f in flows
            if (f.src, f.dst) in wanted and f.tuple5.protocol in self.filter_protocols
        ]


def synthesize_flows(
    workload: WorkloadDescription,
    *,
    nic_ip: "callable[[str, int], str]",
    nics_per_server: int = 2,
    bytes_per_flow: int = 0,
    base_port: int = 49152,
    protocol: int = PROTO_UDP,
) -> list[Flow]:
    """Materialize concrete flows for a workload.

    This is what the NIC / ``ss`` query returns in the real tool: one
    5-tuple per flow.  Flows for a pair are spread round-robin over the
    (src NIC x dst NIC) combinations — each NIC has its own IP — and get
    distinct source ports, which is exactly the entropy ECMP hashes over.

    ``bytes_per_flow`` is the global default volume; a pair carrying its
    own ``PairSpec.bytes_per_flow`` overrides it, so heterogeneous-volume
    workloads are expressible from the description alone.
    """
    flows: list[Flow] = []
    fid = itertools.count()
    for pair in workload.pairs:
        pair_bytes = (pair.bytes_per_flow if pair.bytes_per_flow is not None
                      else bytes_per_flow)
        nic_combos = [
            (s_nic, d_nic)
            for s_nic in range(nics_per_server)
            for d_nic in range(nics_per_server)
        ]
        for k in range(pair.num_flows):
            s_nic, d_nic = nic_combos[k % len(nic_combos)]
            t5 = FiveTuple(
                src_ip=nic_ip(pair.src, s_nic),
                dst_ip=nic_ip(pair.dst, d_nic),
                src_port=base_port + k,
                dst_port=ROCE_UDP_DPORT if protocol == PROTO_UDP else 5001,
                protocol=protocol,
            )
            flows.append(
                Flow(
                    flow_id=next(fid),
                    src=pair.src,
                    dst=pair.dst,
                    tuple5=t5,
                    bytes=pair_bytes,
                )
            )
    return flows


def bipartite_pairs(
    rack_a: Sequence[str],
    rack_b: Sequence[str],
    flows_per_pair: int,
    *,
    bytes_per_flow: int | Sequence[int] | None = None,
) -> WorkloadDescription:
    """The paper's Fig. 2(b) bipartite pattern: server i in rack A exchanges
    traffic with server i in rack B, both directions, saturating the
    cross-rack links.  16 directed pairs x 16 flows = 256 flows on the
    paper testbed.

    ``bytes_per_flow`` optionally sets flow volumes: a scalar applies to
    every pair, a sequence gives server-pair ``i`` (both directions) its
    own volume — the bipartite + heterogeneous-volume scenario.
    """
    assert len(rack_a) == len(rack_b)
    if isinstance(bytes_per_flow, (str, bytes)):
        raise TypeError(
            f"bytes_per_flow must be an int or a sequence of ints, "
            f"got {bytes_per_flow!r}")
    if bytes_per_flow is None:
        per_pair: list[int | None] = [None] * len(rack_a)
    else:
        try:
            items = iter(bytes_per_flow)
        except TypeError:   # scalar, including numpy integer scalars
            per_pair = [int(bytes_per_flow)] * len(rack_a)
        else:               # element errors propagate with their own message
            per_pair = [int(v) for v in items]
        if len(per_pair) != len(rack_a):
            raise ValueError(
                f"bytes_per_flow has {len(per_pair)} entries for "
                f"{len(rack_a)} server pairs")
    pairs = []
    for (a, b), volume in zip(zip(rack_a, rack_b), per_pair):
        pairs.append(PairSpec(a, b, flows_per_pair, bytes_per_flow=volume))
        pairs.append(PairSpec(b, a, flows_per_pair, bytes_per_flow=volume))
    return WorkloadDescription(pairs=pairs)


def workload_from_flows(flows: Iterable[Flow]) -> WorkloadDescription:
    """Recover the paper-Step-(1) description from a concrete flow list
    (e.g. the HLO-derived flows of ``core/llm_workload.py``): pairs in
    first-seen order, per-pair flow counts, and per-pair byte specs.

    A pair whose flows carry different volumes (one pair serving both an
    all-reduce ring edge and an all-to-all edge) is summarized by its
    *mean* bytes per flow — the description is per-pair granular; keep
    the explicit flow list when exact per-flow volumes matter.
    """
    counts: dict[tuple[str, str], int] = {}
    volumes: dict[tuple[str, str], int] = {}
    for f in flows:
        key = (f.src, f.dst)
        counts[key] = counts.get(key, 0) + 1
        volumes[key] = volumes.get(key, 0) + f.bytes
    # always pin the spec (0 stays 0): leaving an all-zero pair at None
    # would let a synthesize-time default silently inflate it
    pairs = [
        PairSpec(src, dst, n, bytes_per_flow=round(volumes[(src, dst)] / n))
        for (src, dst), n in counts.items()
    ]
    return WorkloadDescription(pairs=pairs)
