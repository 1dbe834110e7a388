"""Compiled-HLO -> flow extraction (the port's own copy of
``repro.core.hlo_flows``: host text processing, no tensors).

The paper's first-hop discovery asks the NIC driver which flows exist.
For an XLA-compiled training step we can do strictly better: the SPMD
partitioner has already decided every collective the program will run, so
the *compiled HLO text* is a complete, passive description of the job's
network traffic.  This module:

  1. parses every collective op (all-reduce / all-gather / reduce-scatter /
     all-to-all / collective-permute, sync or async-start form) with its
     shape and replica groups (explicit or iota-v2 format);
  2. models per-device wire bytes for each (ring algorithms for AR/AG/RS,
     pairwise for A2A, explicit pairs for permute) — this feeds the
     roofline collective term;
  3. decomposes inter-host traffic into point-to-point ``Flow`` records
     with RoCEv2 5-tuples so FlowTracer can trace them across the DCN
     fabric model.  Intra-host (chip-to-chip) and intra-pod ICI edges are
     tallied separately — ICI routing is deterministic (no ECMP), so only
     pod-crossing flows enter the Clos analysis (DESIGN.md section 2).
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import defaultdict
from collections.abc import Mapping, Sequence

from .flows import Flow, FiveTuple, ROCE_UDP_DPORT, PROTO_UDP

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "s4": 1, "s8": 1, "u2": 1, "u4": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3fnuz": 1,
    "f8e5m2fnuz": 1, "f8e3m4": 1, "f8e4m3": 1,
}

_SHAPE_RE = re.compile(r"([a-z]\w*)\[([\d,]*)\]")
_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all", "collective-broadcast",
)
# op line:  %name = SHAPE opname(...), attrs
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(" + "|".join(_COLLECTIVES) + r")(-start)?\("
)
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{(\{[\d,{}\s]*\})\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?"
)
_PAIRS_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)*)\}")
_CHANNEL_RE = re.compile(r"channel_id=(\d+)")

# computation header: `%name (args) -> type {`  or  `ENTRY %name ...{`
# (args may contain nested parens for tuple types -> greedy match)
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$")
_WHILE_RE = re.compile(r"while\(.*?body=%?([\w.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALL_RE = re.compile(r"\bcall\(.*?to_apply=%?([\w.\-]+)")


def computation_multipliers(hlo_text: str) -> dict[str, int]:
    """Execution count of each HLO computation, from while-loop
    known_trip_count backend configs (XLA counts loop bodies ONCE in
    cost_analysis; collectives inside scan bodies run trip_count times).

    Returns {computation_name: multiplier}; ENTRY has multiplier 1.
    """
    comps: dict[str, list[str]] = {}
    entry = None
    cur: list[str] | None = None
    for line in hlo_text.splitlines():
        m = _COMP_RE.match(line)
        if m:
            cur = comps.setdefault(m.group(1), [])
            if line.lstrip().startswith("ENTRY"):
                entry = m.group(1)
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is not None:
            cur.append(line)

    # edges: computation -> [(child, weight)]
    edges: dict[str, list[tuple[str, int]]] = {name: [] for name in comps}
    for name, lines in comps.items():
        for line in lines:
            wm = _WHILE_RE.search(line)
            if wm:
                tm = _TRIP_RE.search(line)
                trip = int(tm.group(1)) if tm else 1
                edges[name].append((wm.group(1), trip))
                continue
            cm = _CALL_RE.search(line)
            if cm:
                edges[name].append((cm.group(1), 1))

    if entry is None:
        return {name: 1 for name in comps}
    # fixed-point over the (acyclic) computation-call DAG: each
    # computation's count is the sum over parents of parent_count * weight.
    mult: dict[str, int] = {name: (1 if name == entry else 0) for name in comps}
    for _ in range(len(comps) + 2):
        new = {name: (1 if name == entry else 0) for name in comps}
        for parent, out in edges.items():
            for child, w in out:
                if child in new:
                    new[child] += mult.get(parent, 0) * w
        new[entry] = 1
        if new == mult:
            break
        mult = new
    return {name: max(1, v) for name, v in mult.items()}


def op_computations(hlo_text: str) -> dict[int, str]:
    """line number -> enclosing computation name."""
    out: dict[int, str] = {}
    cur = "<none>"
    for i, line in enumerate(hlo_text.splitlines()):
        m = _COMP_RE.match(line)
        if m:
            cur = m.group(1)
        out[i] = cur
    return out


def shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape token like ``bf16[256,4096]{1,0}``.
    Tuple shapes sum their elements."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dtype, dims = m.group(1), m.group(2)
        if dtype == "token" or dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _parse_groups(line: str) -> list[list[int]]:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        num_groups, group_size = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        total = math.prod(dims)
        ids = list(range(total))
        # reshape -> transpose -> flatten, pure python (dims are small)
        if m.group(4):
            perm = [int(x) for x in m.group(4).split(",")]
            # index math: element at flat position p has multi-index over dims
            strides = [0] * len(dims)
            acc = 1
            for i in range(len(dims) - 1, -1, -1):
                strides[i] = acc
                acc *= dims[i]
            tdims = [dims[p] for p in perm]
            tstrides = [strides[p] for p in perm]
            out = []
            idx = [0] * len(tdims)
            for _ in range(total):
                out.append(sum(i * s for i, s in zip(idx, tstrides)))
                for ax in range(len(tdims) - 1, -1, -1):
                    idx[ax] += 1
                    if idx[ax] < tdims[ax]:
                        break
                    idx[ax] = 0
            ids = out
        return [ids[g * group_size : (g + 1) * group_size]
                for g in range(num_groups)]
    m = _GROUPS_EXPLICIT_RE.search(line)
    if m:
        inner = m.group(1)
        groups = re.findall(r"\{([\d,\s]*)\}", inner)
        return [[int(x) for x in g.split(",") if x.strip()] for g in groups if g.strip()]
    return []


def _parse_pairs(line: str) -> list[tuple[int, int]]:
    m = _PAIRS_RE.search(line)
    if not m:
        return []
    return [tuple(int(v) for v in p.split(","))
            for p in re.findall(r"\{(\d+,\d+)\}", m.group(1))]


@dataclasses.dataclass(frozen=True, slots=True)
class CollectiveOp:
    kind: str                      # all-reduce / all-gather / ...
    result_bytes: int              # per-device result buffer
    operand_bytes: int             # per-device operand buffer
    wire_bytes: int                # modeled per-device bytes on the wire, ONE execution
    groups: tuple[tuple[int, ...], ...]
    pairs: tuple[tuple[int, int], ...]  # collective-permute only
    channel_id: int
    line_no: int
    multiplier: int = 1            # executions per step (while trip counts)

    @property
    def total_wire_bytes(self) -> int:
        return self.wire_bytes * self.multiplier


def wire_and_operand(kind: str, result_bytes: int, n: int) -> tuple[int, int]:
    """Per-device (wire_bytes, operand_bytes) under ring algorithms.

    Public byte model shared with synthetic collective generators
    (``core/llm_workload.py``)."""
    if kind not in _COLLECTIVES:
        raise ValueError(kind)
    if n <= 1:
        # nothing on the wire; still report operand bytes for bookkeeping
        return 0, result_bytes
    if kind == "all-reduce":
        return int(2 * (n - 1) / n * result_bytes), result_bytes
    if kind in ("all-gather", "collective-broadcast"):
        return int((n - 1) / n * result_bytes), result_bytes // n
    if kind == "reduce-scatter":
        operand = result_bytes * n
        return (n - 1) * result_bytes, operand
    if kind in ("all-to-all", "ragged-all-to-all"):
        return int((n - 1) / n * result_bytes), result_bytes
    # collective-permute: every pair moves the full buffer
    return result_bytes, result_bytes


def extract_collectives(hlo_text: str) -> list[CollectiveOp]:
    """Parse collectives with per-op execution multipliers (loop trip
    counts), since ops inside scan bodies appear once in the text."""
    mults = computation_multipliers(hlo_text)
    comp_of = op_computations(hlo_text)
    ops: list[CollectiveOp] = []
    for ln_no, line in enumerate(hlo_text.splitlines()):
        m = _OP_RE.match(line)
        if not m:
            continue
        shape_str, kind, is_start = m.group(1), m.group(2), bool(m.group(3))
        # async -start ops of gather/permute return (operand, result, ...):
        # use the LAST array element as the result buffer.
        if is_start and shape_str.startswith("("):
            # async -start tuple: last array element is the output buffer
            shapes = _SHAPE_RE.findall(shape_str)
            if shapes:
                dtype, dims = shapes[-1]
                dims_s = f"{dtype}[{dims}]"
                result_bytes = shape_bytes(dims_s)
            else:
                result_bytes = 0
        else:
            result_bytes = shape_bytes(shape_str)

        pairs = tuple(_parse_pairs(line))
        groups = tuple(tuple(g) for g in _parse_groups(line))
        if kind == "collective-permute":
            n = 2 if pairs else 1
            wire, operand = (result_bytes, result_bytes) if pairs else (0, result_bytes)
        else:
            n = max((len(g) for g in groups), default=1)
            wire, operand = wire_and_operand(kind, result_bytes, n)
        chan = _CHANNEL_RE.search(line)
        ops.append(
            CollectiveOp(
                kind=kind,
                result_bytes=result_bytes,
                operand_bytes=operand,
                wire_bytes=wire,
                groups=groups,
                pairs=pairs,
                channel_id=int(chan.group(1)) if chan else 0,
                line_no=ln_no,
                multiplier=mults.get(comp_of.get(ln_no, ""), 1),
            )
        )
    return ops


@dataclasses.dataclass
class CollectiveSummary:
    per_kind_wire: dict[str, int]
    per_kind_count: dict[str, int]
    total_wire_bytes: int          # per device
    total_operand_bytes: int       # per device (prompt-faithful roofline input)

    @property
    def total_count(self) -> int:
        return sum(self.per_kind_count.values())


def summarize(ops: Sequence[CollectiveOp]) -> CollectiveSummary:
    """Totals with loop multipliers applied (true per-step wire traffic)."""
    wire: dict[str, int] = defaultdict(int)
    count: dict[str, int] = defaultdict(int)
    for op in ops:
        wire[op.kind] += op.total_wire_bytes
        count[op.kind] += op.multiplier
    return CollectiveSummary(
        per_kind_wire=dict(wire),
        per_kind_count=dict(count),
        total_wire_bytes=sum(op.total_wire_bytes for op in ops),
        total_operand_bytes=sum(op.operand_bytes * op.multiplier for op in ops),
    )


# ---------------------------------------------------------------------------
# Decomposition into point-to-point flows (FlowTracer input)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EdgeClassCounts:
    """Where a collective's ring edges land in the machine."""

    intra_host: int = 0
    intra_pod_ici: int = 0
    inter_pod_dcn: int = 0
    dcn_bytes: int = 0
    ici_bytes: int = 0


def _ring_edges(group: Sequence[int]) -> list[tuple[int, int]]:
    n = len(group)
    return [(group[i], group[(i + 1) % n]) for i in range(n)] if n > 1 else []


def collectives_to_flows(
    ops: Sequence[CollectiveOp],
    coords: Mapping[int, tuple[int, int, int]],
    *,
    host_name: "callable[[int], str] | None" = None,
    nic_ip: "callable[[str, int], str] | None" = None,
    base_port: int = 49152,
) -> tuple[list[Flow], EdgeClassCounts]:
    """Decompose collectives into inter-host DCN flows.

    ``coords[device] = (pod, global_host, chip)``.  Ring edges between
    chips on the same host never touch a network; edges within a pod ride
    the ICI torus (deterministic); only pod-crossing edges become DCN
    flows with RoCE 5-tuples for the Clos fabric.
    """
    if host_name is None:
        host_name = lambda h: f"host-{h}"
    if nic_ip is None:
        from .fabric import nic_ip as _nip
        nic_ip = _nip

    flows: list[Flow] = []
    stats = EdgeClassCounts()
    fid = 0
    for op in ops:
        if op.kind == "collective-permute":
            edges = list(op.pairs)
            per_edge_bytes = op.result_bytes
            edge_sets = [edges]
        elif op.kind in ("all-to-all", "ragged-all-to-all"):
            edge_sets = []
            for g in op.groups:
                n = len(g)
                if n > 1:
                    edge_sets.append(
                        [(a, b) for a in g for b in g if a != b]
                    )
            per_edge_bytes = None  # computed per group below
        else:
            edge_sets = [_ring_edges(g) for g in op.groups]
            per_edge_bytes = None

        for g_idx, edges in enumerate(edge_sets):
            if not edges:
                continue
            if per_edge_bytes is None:
                n = len(op.groups[g_idx]) if op.groups else 2
                if op.kind == "all-reduce":
                    eb = int(2 * (n - 1) / n * op.result_bytes)
                elif op.kind in ("all-gather", "collective-broadcast"):
                    eb = int((n - 1) / n * op.result_bytes)
                elif op.kind == "reduce-scatter":
                    eb = (n - 1) * op.result_bytes
                elif op.kind in ("all-to-all", "ragged-all-to-all"):
                    eb = op.result_bytes // max(1, n)
                else:
                    eb = op.result_bytes
            else:
                eb = per_edge_bytes
            eb *= op.multiplier   # repeated executions = one elephant flow
            for e_idx, (a, b) in enumerate(edges):
                pa, ha, _ = coords[a]
                pb, hb, _ = coords[b]
                if ha == hb:
                    stats.intra_host += 1
                    continue
                if pa == pb:
                    stats.intra_pod_ici += 1
                    stats.ici_bytes += eb
                    continue
                stats.inter_pod_dcn += 1
                stats.dcn_bytes += eb
                src, dst = host_name(ha), host_name(hb)
                t5 = FiveTuple(
                    src_ip=nic_ip(src, 0),
                    dst_ip=nic_ip(dst, 0),
                    src_port=base_port + ((op.channel_id * 131 + e_idx * 7919) % 16384),
                    dst_port=ROCE_UDP_DPORT,
                    protocol=PROTO_UDP,
                )
                flows.append(
                    Flow(flow_id=fid, src=src, dst=dst, tuple5=t5, bytes=eb,
                         label=f"{op.kind}#ch{op.channel_id}")
                )
                fid += 1
    return flows, stats
