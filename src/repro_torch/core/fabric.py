"""Fabric model: devices, links, and the functions that build topologies.

The port's own copy of ``repro.core.fabric`` (the port imports nothing of
``repro``); keep the two in step.

This is the "network topology file" of the paper (Section III-A): it lists
every device, every interface, and how interfaces connect.  The tracer uses
it to map the egress interface reported by one device to the ingress
interface of the next.

Two families of fabrics are modeled:

* ``build_paper_testbed`` — the paper's 2-rack RoCEv2 cluster: 16 servers
  (2 dual-port 100G NICs each, one NIC per ToR), 4 leaf switches
  (3.2 Tb/s), 4 spine switches (1.6 Tb/s), 4x100G links per leaf-spine
  pair.  256 bipartite flows -> ideal 4 flows per link on every layer.
* ``build_multipod_fabric`` — the TPU adaptation: pods of hosts whose
  inter-pod (DCN) traffic crosses an Ethernet leaf-spine Clos with ECMP,
  which is exactly the regime the paper studies.  Intra-pod ICI links are
  modeled separately with deterministic routing (no hash decisions).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from collections.abc import Sequence

SERVER = "server"
LEAF = "leaf"
SPINE = "spine"

# Link layers used for FIM grouping (paper Fig. 3(b,c) subplots).
HOST_TO_LEAF = "host-to-leaf"
LEAF_TO_SPINE = "leaf-to-spine"
SPINE_TO_LEAF = "spine-to-leaf"
LEAF_TO_HOST = "leaf-to-host"


@dataclasses.dataclass(frozen=True, slots=True)
class Link:
    """A unidirectional link between two device ports."""

    src: str
    src_port: str
    dst: str
    dst_port: str
    gbps: float
    layer: str

    @property
    def name(self) -> str:
        return f"{self.src}:{self.src_port}->{self.dst}:{self.dst_port}"


@dataclasses.dataclass(frozen=True, slots=True)
class Device:
    name: str
    kind: str  # server | leaf | spine
    rack: int | None = None
    pod: int | None = None


class Fabric:
    """Topology file + adjacency helpers (paper Section III-A)."""

    def __init__(self, devices: Sequence[Device], links: Sequence[Link]):
        self.devices: dict[str, Device] = {d.name: d for d in devices}
        self.links: list[Link] = list(links)
        self._egress: dict[str, list[Link]] = defaultdict(list)
        self._by_pair: dict[tuple[str, str], list[Link]] = defaultdict(list)
        self._by_src_port: dict[tuple[str, str], Link] = {}
        for ln in self.links:
            self._egress[ln.src].append(ln)
            self._by_pair[(ln.src, ln.dst)].append(ln)
            self._by_src_port[(ln.src, ln.src_port)] = ln

    # -- queries used by the tracer ---------------------------------------
    def egress_links(self, device: str) -> list[Link]:
        return self._egress[device]

    def links_between(self, src: str, dst: str) -> list[Link]:
        return self._by_pair.get((src, dst), [])

    def link_from_port(self, device: str, port: str) -> Link:
        """Topology-file lookup: egress interface -> the link it drives ->
        the next device's ingress interface (paper Section III-B.2)."""
        return self._by_src_port[(device, port)]

    def kind(self, device: str) -> str:
        return self.devices[device].kind

    def links_by_layer(self, layer: str) -> list[Link]:
        return [ln for ln in self.links if ln.layer == layer]

    @property
    def layers(self) -> list[str]:
        seen: list[str] = []
        for ln in self.links:
            if ln.layer not in seen:
                seen.append(ln.layer)
        return seen

    # -- (de)serialization: the literal "topology file" -------------------
    def to_json(self) -> dict:
        return {
            "devices": [dataclasses.asdict(d) for d in self.devices.values()],
            "links": [dataclasses.asdict(l) for l in self.links],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Fabric":
        return cls(
            [Device(**d) for d in obj["devices"]],
            [Link(**l) for l in obj["links"]],
        )


# ---------------------------------------------------------------------------
# NIC addressing helpers
# ---------------------------------------------------------------------------

def nic_ip(server: str, nic: int) -> str:
    """Deterministic per-NIC IP.  Each dual-port NIC owns one IP; the two
    ports of a NIC form a LAG into a single leaf (so the leaf's downlink
    choice is a 2-way hash — the paper's 4th cross-rack ECMP decision)."""
    idx = int(server.split("-")[-1])
    return f"10.{nic}.{idx // 256}.{idx % 256}"


def server_name(i: int) -> str:
    return f"srv-{i}"


# ---------------------------------------------------------------------------
# Paper testbed (Fig. 2a)
# ---------------------------------------------------------------------------

def build_paper_testbed(
    *,
    num_racks: int = 2,
    servers_per_rack: int = 8,
    leaves_per_rack: int = 2,
    num_spines: int = 4,
    links_per_leaf_spine: int = 4,
    link_gbps: float = 100.0,
    ports_per_nic: int = 2,
) -> Fabric:
    """The paper's 2-rack testbed.

    Derivation from the paper's numbers: 4 leaves x 4 spines x 4 links
    = 64 leaf->spine links; 256 bipartite flows / 64 links = the paper's
    "4 flows per link for a perfectly balanced distribution".  Every server
    has two dual-port 100G NICs (400 Gb/s total); NIC k LAGs its two ports
    into leaf k of the rack.
    """
    devices: list[Device] = []
    links: list[Link] = []

    spines = [f"spine-{s}" for s in range(num_spines)]
    devices += [Device(s, SPINE) for s in spines]

    for r in range(num_racks):
        leaves = [f"leaf-{r * leaves_per_rack + l}" for l in range(leaves_per_rack)]
        devices += [Device(l, LEAF, rack=r) for l in leaves]

        for s in range(servers_per_rack):
            i = r * servers_per_rack + s
            srv = server_name(i)
            devices.append(Device(srv, SERVER, rack=r))
            for nic in range(leaves_per_rack):  # NIC k -> leaf k (LAG of 2 ports)
                leaf = leaves[nic]
                for p in range(ports_per_nic):
                    links.append(
                        Link(srv, f"nic{nic}p{p}", leaf, f"host-{srv}-{nic}-{p}",
                             link_gbps, HOST_TO_LEAF)
                    )
                    links.append(
                        Link(leaf, f"down-{srv}-{nic}-{p}", srv, f"nic{nic}p{p}",
                             link_gbps, LEAF_TO_HOST)
                    )
        for leaf in leaves:
            for spine in spines:
                for k in range(links_per_leaf_spine):
                    links.append(
                        Link(leaf, f"up-{spine}-{k}", spine, f"in-{leaf}-{k}",
                             link_gbps, LEAF_TO_SPINE)
                    )
                    links.append(
                        Link(spine, f"down-{leaf}-{k}", leaf, f"spinein-{spine}-{k}",
                             link_gbps, SPINE_TO_LEAF)
                    )
    return Fabric(devices, links)


# ---------------------------------------------------------------------------
# Multi-pod TPU DCN fabric (hardware adaptation — DESIGN.md section 2)
# ---------------------------------------------------------------------------

def build_multipod_fabric(
    *,
    num_pods: int = 2,
    hosts_per_pod: int = 64,
    leaves_per_pod: int = 4,
    num_spines: int = 8,
    links_per_leaf_spine: int = 4,
    host_link_gbps: float = 100.0,
    fabric_link_gbps: float = 400.0,
    nics_per_host: int = 1,
    ports_per_nic: int = 2,
) -> Fabric:
    """DCN fabric connecting TPU pods.

    Each pod is a "rack" of hosts (a host fronts 4 TPU chips on v5e).
    Inter-pod collective traffic — the flows on the ``pod`` mesh axis —
    crosses leaf -> spine -> leaf with an ECMP decision at each stage,
    i.e. the exact hash-collision regime of the paper.  Intra-pod ICI is
    NOT part of this fabric (deterministic torus; see hlo_flows.py).
    """
    devices: list[Device] = []
    links: list[Link] = []
    spines = [f"spine-{s}" for s in range(num_spines)]
    devices += [Device(s, SPINE) for s in spines]

    for pod in range(num_pods):
        leaves = [f"leaf-{pod * leaves_per_pod + l}" for l in range(leaves_per_pod)]
        devices += [Device(l, LEAF, rack=pod, pod=pod) for l in leaves]
        for h in range(hosts_per_pod):
            i = pod * hosts_per_pod + h
            srv = f"host-{i}"
            devices.append(Device(srv, SERVER, rack=pod, pod=pod))
            for nic in range(nics_per_host):
                leaf = leaves[h % leaves_per_pod] if nics_per_host == 1 else leaves[nic % leaves_per_pod]
                for p in range(ports_per_nic):
                    links.append(Link(srv, f"nic{nic}p{p}", leaf,
                                      f"host-{srv}-{nic}-{p}", host_link_gbps,
                                      HOST_TO_LEAF))
                    links.append(Link(leaf, f"down-{srv}-{nic}-{p}", srv,
                                      f"nic{nic}p{p}", host_link_gbps,
                                      LEAF_TO_HOST))
        for leaf in leaves:
            for spine in spines:
                for k in range(links_per_leaf_spine):
                    links.append(Link(leaf, f"up-{spine}-{k}", spine,
                                      f"in-{leaf}-{k}", fabric_link_gbps,
                                      LEAF_TO_SPINE))
                    links.append(Link(spine, f"down-{leaf}-{k}", leaf,
                                      f"spinein-{spine}-{k}", fabric_link_gbps,
                                      SPINE_TO_LEAF))
    return Fabric(devices, links)


def host_of_nic_ip(ip: str) -> tuple[int, int]:
    """Inverse of nic_ip: ip -> (server index, nic index)."""
    parts = ip.split(".")
    return int(parts[2]) * 256 + int(parts[3]), int(parts[1])
