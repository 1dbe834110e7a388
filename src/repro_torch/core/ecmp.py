"""Routing policies: ECMP hashing (with VXLAN entropy reduction) and
preprogrammed static routing.

The port's own copy of ``repro.core.ecmp`` (the port imports nothing of
``repro``); keep the two in step.  The splitmix64-over-CRC32
``ecmp_hash`` (which the VXLAN field mode folds the inner 5-tuple with),
the per-flow hash fields in all three modes and the ``Forwarder``, whose
candidate order ``compile_fabric`` records, feed the Monte-Carlo walk.
``EcmpRouting`` picks by hashing flow headers per switch under
``device_seed`` (why collisions differ hop to hop); ``StaticRouting``
consults a preprogrammed table (the paper's second configuration).  The
hop-by-hop tracer (``core/tracer.py``) asks these policies at every hop,
and the walk under the ``exact`` backend makes the same choices.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections.abc import Sequence

import numpy as np

from .fabric import Fabric, Link, LEAF, SERVER, SPINE
from .flows import Flow

_MASK = (1 << 64) - 1

# Hash-field presets.  VXLAN encapsulation hides the inner 5-tuple from
# transit switches; entropy survives only via the outer UDP source port
# (derived from an inner-header hash) — fewer effective fields, more
# collisions (paper Section II).
FIELDS_5TUPLE = "5tuple"
FIELDS_VXLAN = "vxlan"
FIELDS_IP_PAIR = "ip-pair"


def _mix64(x: int) -> int:
    x &= _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return (x ^ (x >> 31)) & _MASK


def _crc(s: str) -> int:
    return zlib.crc32(s.encode())


HASH_INIT = 0x9E3779B97F4A7C15


def ecmp_hash(fields: Sequence[int], seed: int) -> int:
    h = _mix64(seed ^ HASH_INIT)
    for f in fields:
        h = _mix64(h ^ (f & _MASK))
    return h


def device_seed(device: str, seed: int) -> int:
    """The effective per-switch hash seed: every device salts the shared
    run seed with a stable digest of its own name (real switches differ in
    per-ASIC seeds the same way — that is why collisions differ hop to
    hop)."""
    return _crc(device) ^ seed


def flow_hash_fields(flow: Flow, mode: str) -> list[int]:
    t = flow.tuple5
    if mode == FIELDS_5TUPLE:
        return [_crc(t.src_ip), _crc(t.dst_ip), t.src_port, t.dst_port, t.protocol]
    if mode == FIELDS_VXLAN:
        # Outer header: (outer src ip, outer dst ip, outer UDP sport).  The
        # sport is the VTEP's hash of the inner 5-tuple folded to 14 bits.
        inner = ecmp_hash(
            [_crc(t.src_ip), _crc(t.dst_ip), t.src_port, t.dst_port, t.protocol],
            seed=0x564C414E,  # "VLAN"
        )
        return [_crc(t.src_ip), _crc(t.dst_ip), inner % 16384]
    if mode == FIELDS_IP_PAIR:
        return [_crc(t.src_ip), _crc(t.dst_ip)]
    raise ValueError(f"unknown hash-field mode: {mode}")


def flow_fields_matrix(flows: Sequence[Flow], mode: str) -> np.ndarray:
    """Integer hash fields for many flows as a dense ``(N, F)`` uint64
    array — the batched twin of ``flow_hash_fields`` (identical values)."""
    return np.array(
        [flow_hash_fields(f, mode) for f in flows], np.uint64
    ).reshape(len(flows), -1)


# ---------------------------------------------------------------------------
# Candidate-set computation (the "equal cost" part of ECMP)
# ---------------------------------------------------------------------------


class Forwarder:
    """Computes the equal-cost candidate egress set at each device.

    This encodes the L3 Clos forwarding logic:
      * server:  LAG over the ports of the NIC owning the flow's src ip;
      * leaf:    if the dst NIC is locally attached -> LAG down to it,
                 otherwise ECMP over all uplinks (any spine reaches any leaf);
      * spine:   ECMP over the links to the leaf behind the dst NIC.
    """

    def __init__(self, fabric: Fabric):
        self.fabric = fabric
        # (server, nic index) -> the NIC's host-to-leaf ports.
        self._server_nic_links: dict[tuple[str, int], list[Link]] = {}
        for ln in fabric.links:
            if fabric.kind(ln.src) == SERVER and ln.src_port.startswith("nic"):
                nic = int(ln.src_port[3 : ln.src_port.index("p")])
                self._server_nic_links.setdefault((ln.src, nic), []).append(ln)

    def _nic_of_ip(self, ip: str) -> tuple[str, int]:
        # 10.<nic>.<hi>.<lo> (fabric.nic_ip) — server index from last octets.
        parts = ip.split(".")
        nic = int(parts[1])
        idx = int(parts[2]) * 256 + int(parts[3])
        for prefix in ("srv-", "host-"):
            name = f"{prefix}{idx}"
            if name in self.fabric.devices:
                return name, nic
        raise KeyError(f"no server for ip {ip}")

    def attachment_leaf(self, ip: str) -> str:
        server, nic = self._nic_of_ip(ip)
        links = self._server_nic_links[(server, nic)]
        return links[0].dst  # both LAG ports land on the same leaf

    def candidates(self, device: str, flow: Flow) -> list[Link]:
        fab = self.fabric
        kind = fab.kind(device)
        if kind == SERVER:
            server, nic = self._nic_of_ip(flow.tuple5.src_ip)
            assert server == device, (server, device, "flow must start at src")
            return sorted(self._server_nic_links[(device, nic)],
                          key=lambda l: l.src_port)
        dst_server, dst_nic = self._nic_of_ip(flow.tuple5.dst_ip)
        dst_leaf = self.attachment_leaf(flow.tuple5.dst_ip)
        if kind == LEAF:
            if device == dst_leaf:  # LAG down to the dst NIC's ports
                down = [
                    l for l in fab.links_between(device, dst_server)
                    if l.dst_port.startswith(f"nic{dst_nic}p")
                ]
                return sorted(down, key=lambda l: l.src_port)
            ups = [l for l in fab.egress_links(device) if fab.kind(l.dst) == SPINE]
            return sorted(ups, key=lambda l: (l.dst, l.src_port))
        if kind == SPINE:
            downs = fab.links_between(device, dst_leaf)
            return sorted(downs, key=lambda l: l.src_port)
        raise ValueError(f"unknown device kind {kind}")


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


class RoutingPolicy:
    """Interface: the forwarding decision a device would reveal via its
    hash-visibility CLI (switches) or driver/route table (servers)."""

    def egress(self, device: str, flow: Flow, ingress_port: str | None) -> Link:
        raise NotImplementedError


@dataclasses.dataclass
class EcmpRouting(RoutingPolicy):
    fabric: Fabric
    seed: int = 0
    fields: str = FIELDS_5TUPLE

    def __post_init__(self):
        self.forwarder = Forwarder(self.fabric)

    def egress(self, device: str, flow: Flow, ingress_port: str | None) -> Link:
        cands = self.forwarder.candidates(device, flow)
        if len(cands) == 1:
            return cands[0]
        h = ecmp_hash(flow_hash_fields(flow, self.fields),
                      device_seed(device, self.seed))
        return cands[h % len(cands)]


class StaticRouting(RoutingPolicy):
    """Preprogrammed routing: an explicit (device, flow) -> egress-port map,
    as produced by placement.static_route_assignment.  Falls back to the
    single candidate when no choice exists."""

    def __init__(self, fabric: Fabric, table: dict[tuple[str, int], str]):
        self.fabric = fabric
        self.forwarder = Forwarder(fabric)
        self.table = table  # (device, flow_id) -> src_port

    def egress(self, device: str, flow: Flow, ingress_port: str | None) -> Link:
        port = self.table.get((device, flow.flow_id))
        if port is not None:
            return self.fabric.link_from_port(device, port)
        cands = self.forwarder.candidates(device, flow)
        if len(cands) != 1:
            raise KeyError(
                f"static table has no entry for ({device}, flow {flow.flow_id}) "
                f"and {len(cands)} candidates exist"
            )
        return cands[0]
