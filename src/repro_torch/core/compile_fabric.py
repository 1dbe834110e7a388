"""Compile a ``Fabric`` + forwarding logic into dense arrays.

The port's own copy of ``repro.core.compile_fabric``.  The fabric is
compiled once into integer tables the vectorized walk can index with
whole tensors:

* every device gets an id, a ``crc32(name)`` (the per-switch hash-seed
  component of ECMP), and a server/switch flag;
* every link gets an id plus src/dst-device, layer and capacity columns;
* the equal-cost candidate set at ``(device, flow)`` depends only on the
  device and one *NIC key* — the flow's **src** (server, nic) while the
  packet is on the source host, its **dst** (server, nic) everywhere else
  (Clos forwarding is destination-routed).  So all candidate sets live in
  one padded ``(V, K, C_max)`` table of link ids, built by calling the
  real ``Forwarder`` per (device, key) so candidate *order* — which the
  hash indexes into — is identical to the hop-by-hop path by construction.

The tables are built on the host with numpy; ``CompiledFabric.to(device)``
uploads the ones the walk, the counts, the FIM and the fill read, once
per device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ecmp import Forwarder, _crc
from .fabric import Fabric, Link, SERVER, nic_ip
from .flows import FiveTuple, Flow


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """The compiled tables as tensors on one device.

    Index tables are int64 (torch's index dtype); the candidate tables
    are flattened so the walk gathers with one linear index
    ``(state * K + key) * C_max + choice``."""

    cand: torch.Tensor        # (V * K * C_max,) int64 link ids, -1 padded
    cand_n: torch.Tensor      # (V * K,) int64 candidate count
    dev_crc: torch.Tensor     # (V,) int64 crc32(name)
    is_server: torch.Tensor   # (V,) bool
    link_src: torch.Tensor    # (L,) int64
    link_dst: torch.Tensor    # (L,) int64
    link_layer: torch.Tensor  # (L,) int64
    link_gbps: torch.Tensor   # (L,) float64
    num_keys: int
    c_max: int


@dataclasses.dataclass(frozen=True)
class CompiledFabric:
    """Dense-array view of a fabric, consumed by ``vector_sim``."""

    fabric: Fabric
    # devices
    device_names: list[str]         # device id -> name
    device_id: dict[str, int]       # name -> device id
    dev_crc: np.ndarray             # (V,) uint64  crc32(name)
    is_server: np.ndarray           # (V,) bool
    # links
    links: list[Link]               # link id -> Link
    link_src: np.ndarray            # (L,) int32  src device id
    link_dst: np.ndarray            # (L,) int32  dst device id
    link_layer: np.ndarray          # (L,) int32  layer id
    layer_names: list[str]          # layer id -> name (fabric.layers order)
    link_gbps: np.ndarray           # (L,) float64
    # NIC keys: one per (server, nic index), i.e. one per NIC IP
    key_of_ip: dict[str, int]       # nic ip -> key id
    key_server: np.ndarray          # (K,) int32  device id owning the key
    #: distinct NIC indices present on the fabric's servers, sorted — the
    #: authoritative record of the NIC plan (``resolve_flows`` synthesizes
    #: against it)
    nic_indices: tuple[int, ...]
    # candidate tables
    cand: np.ndarray                # (V, K, C_max) int32 link ids, -1 padded
    cand_n: np.ndarray              # (V, K) int32  candidate count
    #: device -> uploaded ``DeviceTables`` (filled by ``to``)
    _uploaded: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def num_devices(self) -> int:
        return len(self.device_names)

    @property
    def num_links(self) -> int:
        return len(self.links)

    def flow_endpoint_ids(
        self, flows,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-flow (src device id, dst device id, src key, dst key)."""
        src_dev = np.array([self.device_id[f.src] for f in flows], np.int32)
        dst_dev = np.array([self.device_id[f.dst] for f in flows], np.int32)
        src_key = np.array(
            [self.key_of_ip[f.tuple5.src_ip] for f in flows], np.int32)
        dst_key = np.array(
            [self.key_of_ip[f.tuple5.dst_ip] for f in flows], np.int32)
        return src_dev, dst_dev, src_key, dst_key

    def to(self, device: torch.device) -> DeviceTables:
        """The tables on ``device``, uploaded on first use and kept."""
        device = torch.device(device)
        hit = self._uploaded.get(device)
        if hit is not None:
            return hit

        def idx(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        tabs = DeviceTables(
            cand=idx(self.cand.reshape(-1)),
            cand_n=idx(self.cand_n.reshape(-1)),
            dev_crc=torch.from_numpy(
                self.dev_crc.view(np.int64).copy()).to(device),
            is_server=torch.from_numpy(self.is_server.copy()).to(device),
            link_src=idx(self.link_src),
            link_dst=idx(self.link_dst),
            link_layer=idx(self.link_layer),
            link_gbps=torch.from_numpy(
                np.asarray(self.link_gbps, np.float64).copy()).to(device),
            num_keys=int(self.cand.shape[1]),
            c_max=int(self.cand.shape[2]),
        )
        self._uploaded[device] = tabs
        return tabs


def compile_fabric(fabric: Fabric) -> CompiledFabric:
    fwd = Forwarder(fabric)
    device_names = list(fabric.devices)
    device_id = {name: i for i, name in enumerate(device_names)}
    dev_crc = np.array([_crc(n) for n in device_names], np.uint64)
    is_server = np.array(
        [fabric.kind(n) == SERVER for n in device_names], bool)

    links = list(fabric.links)
    link_id = {ln.name: i for i, ln in enumerate(links)}
    layer_names = fabric.layers
    layer_id = {name: i for i, name in enumerate(layer_names)}
    link_src = np.array([device_id[ln.src] for ln in links], np.int32)
    link_dst = np.array([device_id[ln.dst] for ln in links], np.int32)
    link_layer = np.array([layer_id[ln.layer] for ln in links], np.int32)
    link_gbps = np.array([ln.gbps for ln in links], np.float64)

    # NIC keys, in deterministic (server name, nic index) order.
    nic_keys = sorted(fwd._server_nic_links)
    key_of_ip = {nic_ip(srv, nic): k for k, (srv, nic) in enumerate(nic_keys)}
    key_server = np.array(
        [device_id[srv] for srv, _ in nic_keys], np.int32)

    # Candidate table: ask the real Forwarder per (device, key) so both the
    # membership and the order of every equal-cost set match the tracer.
    V, K = len(device_names), len(nic_keys)
    per_cell: list[list[list[int]]] = [[[] for _ in range(K)] for _ in range(V)]
    c_max = 1
    for k, (srv, nic) in enumerate(nic_keys):
        ip = nic_ip(srv, nic)
        probe = Flow(flow_id=-1, src=srv, dst=srv,
                     tuple5=FiveTuple(ip, ip, 0, 0))
        for v, dev in enumerate(device_names):
            # Only the flow's own source host ever forwards on src key;
            # switches are dst-keyed.
            if is_server[v] and dev != srv:
                continue
            ids = [link_id[c.name] for c in fwd.candidates(dev, probe)]
            per_cell[v][k] = ids
            c_max = max(c_max, len(ids))

    cand = np.full((V, K, c_max), -1, np.int32)
    cand_n = np.zeros((V, K), np.int32)
    for v in range(V):
        for k in range(K):
            ids = per_cell[v][k]
            cand_n[v, k] = len(ids)
            if ids:
                cand[v, k, : len(ids)] = ids

    return CompiledFabric(
        fabric=fabric,
        device_names=device_names,
        device_id=device_id,
        dev_crc=dev_crc,
        is_server=is_server,
        links=links,
        link_src=link_src,
        link_dst=link_dst,
        link_layer=link_layer,
        layer_names=layer_names,
        link_gbps=link_gbps,
        key_of_ip=key_of_ip,
        key_server=key_server,
        nic_indices=tuple(sorted({nic for _, nic in nic_keys})),
        cand=cand,
        cand_n=cand_n,
    )
