"""Sequential congestion-aware placement on the card.

``congestion_place`` routes flows one at a time in a given order, each
hop taking the least-loaded candidate link under that seed (the flow's
hash breaking ties), and charges each flow's weight to the links it
took: the chain of the ``congestion-aware`` strategy and of the wave's
residue.  A CUDA tensor launches ``csrc/placement.cu`` (one warp per
seed) or raises; a CPU tensor takes the plain version in ``ref.py``.
``LAUNCHES`` counts kernel launches (CPU calls never count).
"""

from __future__ import annotations

import torch

from . import build
from .ref import congestion_place_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"congestion_place": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fault(fault: torch.Tensor) -> tuple | None:
    """The first fault in placement order over the seeds' reports, as
    the host loop raises it: (order position, seed index, kind, device),
    kind 1 (did not terminate) before kind 2 (wrong device) at one
    position, the lowest seed index first."""
    hit = [(p, k, s, d) for s, (p, k, d) in enumerate(fault.tolist())
           if p >= 0]
    if not hit:
        return None
    p, k, s, d = min(hit)
    return p, s, k, d


def congestion_place(
    cand: torch.Tensor, cand_n: torch.Tensor, dev_crc: torch.Tensor,
    is_server: torch.Tensor, link_dst: torch.Tensor, fields: torch.Tensor,
    seeds: torch.Tensor, src_dev: torch.Tensor, dst_dev: torch.Tensor,
    src_key: torch.Tensor, dst_key: torch.Tensor, weight: torch.Tensor,
    order: torch.Tensor, load: torch.Tensor, link_ids: torch.Tensor,
    mask: torch.Tensor | None = None, *, num_keys: int, c_max: int,
    max_hops: int, murmur: bool,
) -> tuple[int, tuple | None]:
    """Place the flows of ``order`` against the (S, L) float64 ``load``
    (which may hold committed demand), writing their paths into the
    (H, N, S) int32 ``link_ids`` (-1 where no path is written yet) and
    their weights into ``load``, both in place.

    The fabric's tables as ``DeviceTables`` holds them (``cand`` flat
    (V*K*C), int64 ids), fields (N, F) and seeds (S,) as int64 bits,
    per-flow endpoints (N,) int64, weights (N,) float64, ``order`` (N,)
    int64, and ``mask`` an optional (N, S) bool of the cells to place.
    Returns (the longest walk in hops, ``None`` or the first fault as
    (order position, seed index, kind 1: no end in ``max_hops`` hops /
    2: ended elsewhere, the device it ended at))."""
    idx = (cand, cand_n, dev_crc, link_dst, fields, seeds, src_dev, dst_dev,
           src_key, dst_key, order)
    dev = load.device
    for t in idx + (is_server, weight, link_ids) + (
            () if mask is None else (mask,)):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("congestion_place needs contiguous tensors")
    if any(t.dtype != torch.int64 for t in idx):
        raise TypeError("tables, fields, seeds, endpoints and order must "
                        "be int64")
    if (is_server.dtype != torch.bool or weight.dtype != torch.float64
            or load.dtype != torch.float64 or link_ids.dtype != torch.int32
            or (mask is not None and mask.dtype != torch.bool)):
        raise TypeError("is_server and mask bool, weight and load float64, "
                        "link_ids int32")
    n, s = fields.shape[0], seeds.shape[0]
    if (load.dim() != 2 or load.shape[0] != s
            or tuple(link_ids.shape[1:]) != (n, s)
            or link_ids.shape[0] < max_hops
            or (mask is not None and tuple(mask.shape) != (n, s))):
        raise ValueError(
            f"load {tuple(load.shape)}, link_ids {tuple(link_ids.shape)} "
            f"do not fit {n} flows x {s} seeds x {max_hops} hops")
    args = (cand, cand_n, dev_crc, is_server, link_dst, fields, seeds,
            src_dev, dst_dev, src_key, dst_key, weight, order, load,
            link_ids, mask)
    kw = dict(num_keys=num_keys, c_max=c_max, max_hops=max_hops,
              murmur=murmur)
    if dev.type == "cpu":
        return congestion_place_ref(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if fields.shape[1] > 32:
        raise ValueError(f"{fields.shape[1]} hash fields; the kernel holds "
                         f"at most 32")
    fault = torch.full((s, 3), -1, dtype=torch.int64, device=dev)
    hops = torch.zeros(s, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().congestion_place(
            *(a.data_ptr() for a in args[:6]), fields.shape[1],
            *(a.data_ptr() for a in args[6:13]),
            None if mask is None else mask.data_ptr(),
            load.data_ptr(), link_ids.data_ptr(), fault.data_ptr(),
            hops.data_ptr(), n, s, num_keys, c_max, load.shape[1], max_hops,
            int(murmur), stream)
    if rc != 0:
        raise RuntimeError(
            f"congestion_place launch failed with CUDA error {rc}")
    LAUNCHES["congestion_place"] += 1
    return int(hops.max()) if s else 0, _fault(fault.cpu())
