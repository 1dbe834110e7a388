"""Carry simulator state into the port from plain data.

The system has no weights; its state is the compiled fabric tables and
the flow table.  These helpers build the port's own types from numpy
arrays and plain tuples, so another implementation's compiled fabric
(for instance the JAX package's ``CompiledFabric``, field by field) and
flows can be handed to the port exactly.
"""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np

from .core.compile_fabric import CompiledFabric
from .core.fabric import Fabric
from .core.flows import FiveTuple, Flow

#: the array fields of a ``CompiledFabric`` and their dtypes
ARRAY_FIELDS = {
    "dev_crc": np.uint64, "is_server": np.bool_, "link_src": np.int32,
    "link_dst": np.int32, "link_layer": np.int32, "link_gbps": np.float64,
    "key_server": np.int32, "cand": np.int32, "cand_n": np.int32,
}


def compiled_from_arrays(arrays: dict[str, np.ndarray], fabric: Fabric,
                         key_of_ip: dict[str, int]) -> CompiledFabric:
    """A ``CompiledFabric`` from its tables given as numpy arrays.

    ``arrays`` holds every name of ``ARRAY_FIELDS``; ``fabric`` supplies
    the device, link and layer order the tables index, and ``key_of_ip``
    the NIC key of every NIC ip.  Shapes are checked against the fabric.
    """
    missing = sorted(set(ARRAY_FIELDS) - set(arrays))
    if missing:
        raise KeyError(f"compiled_from_arrays is missing {missing}")
    a = {k: np.ascontiguousarray(arrays[k], dt)
         for k, dt in ARRAY_FIELDS.items()}
    device_names = list(fabric.devices)
    links = list(fabric.links)
    V, L, K = len(device_names), len(links), len(key_of_ip)
    want = {"dev_crc": (V,), "is_server": (V,), "link_src": (L,),
            "link_dst": (L,), "link_layer": (L,), "link_gbps": (L,),
            "key_server": (K,), "cand_n": (V, K)}
    for k, shape in want.items():
        if a[k].shape != shape:
            raise ValueError(f"{k} has shape {a[k].shape}, expected {shape}")
    if a["cand"].ndim != 3 or a["cand"].shape[:2] != (V, K):
        raise ValueError(
            f"cand has shape {a['cand'].shape}, expected ({V}, {K}, C_max)")
    return CompiledFabric(
        fabric=fabric,
        device_names=device_names,
        device_id={name: i for i, name in enumerate(device_names)},
        links=links,
        layer_names=fabric.layers,
        key_of_ip=dict(key_of_ip),
        nic_indices=tuple(sorted({int(ip.split(".")[1]) for ip in key_of_ip})),
        **a,
    )


def flows_from_records(
    records: Iterable[tuple],
) -> list[Flow]:
    """Flows from plain tuples ``(flow_id, src, dst, src_ip, dst_ip,
    src_port, dst_port, protocol, bytes)``."""
    out = []
    for (fid, src, dst, sip, dip, sport, dport, proto, nbytes) in records:
        out.append(Flow(flow_id=int(fid), src=src, dst=dst,
                        tuple5=FiveTuple(sip, dip, int(sport), int(dport),
                                         int(proto)),
                        bytes=int(nbytes)))
    return out
