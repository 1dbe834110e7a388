"""Sequential congestion-aware placement on the card.

``congestion_place`` routes flows one at a time in a given order, each
hop taking the least-loaded candidate link under that seed (the flow's
hash breaking ties), and charges each flow's weight to the links it
took: the chain of the ``congestion-aware`` strategy and of the wave's
residue.  A CUDA tensor launches ``csrc/placement.cu`` or raises; a CPU
tensor takes the plain version in ``ref.py``.  ``LAUNCHES`` counts
kernel launches (CPU calls never count).

The kernel runs a warp per seed, ``WARPS`` seeds a block, each seed's
load row in shared memory.  The fabric's tables go to it packed
(``pack_tables``): the candidate rows compacted to the non-empty ones
(``compact_candidates``), the next device of each link with its server
bit, and the seeds of the devices and of each link's next device.  ``plan`` decides, by the shared-memory
budget alone, whether they are staged in shared memory beside the rows
or read from global memory by a second instance of the same kernel.
``chain_inputs`` gathers the per-flow inputs in placement order, as the
kernel reads them.
"""

from __future__ import annotations

import dataclasses

import torch

from . import build
from .ref import congestion_place_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"congestion_place": 0}
#: seeds a block holds: a warp and a (L,) float64 load row each
WARPS = 8
#: dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_BUDGET = 232_448
#: shared memory a warp keeps for its flow's hash fields past the 8 the
#: kernel holds in registers
FIELD_BYTES = 256
#: link ids and next-device codes are int16
_ID_MAX = 2**15 - 1
_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's use of shared memory: the compact tables staged there
    (``shared_tables``) or read from global memory, ``warps`` seeds a
    block, and the dynamic shared memory a block takes."""

    shared_tables: bool
    warps: int
    smem_bytes: int


def compact_candidates(cand: torch.Tensor, cand_n: torch.Tensor,
                       c_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The candidate table as a CSR: (V*K + 1,) int32 row offsets and
    the int16 link ids, row ``vk = device * K + key`` being
    ``cand[vk, :min(cand_n[vk], c_max)]`` (empty rows take no room)."""
    n = cand_n.clamp(max=c_max)
    row_off = torch.zeros(n.numel() + 1, dtype=torch.int32,
                          device=cand.device)
    row_off[1:] = n.cumsum(0)
    keep = torch.arange(c_max, device=cand.device)[None, :] < n[:, None]
    return row_off, cand.reshape(-1, c_max)[keep].to(torch.int16)


def table_layout(n_devices: int, n_rows: int, n_links: int,
                 n_cands: int) -> tuple[dict[str, int], int]:
    """Byte offsets of the packed tables' sections, each 16-byte
    aligned, and their total: the devices' int64 seeds (``crc``), the
    seeds of each link's next device (``lcrc``), the int32 row offsets
    (``row``), the links' int16 next-device codes (``next``) and the
    int16 candidate ids (``cand``)."""
    offs, at = {}, 0
    for name, nbytes in (("crc", 8 * n_devices), ("lcrc", 8 * n_links),
                         ("row", 4 * (n_rows + 1)), ("next", 2 * n_links),
                         ("cand", 2 * n_cands)):
        offs[name] = at
        at += _align16(nbytes)
    return offs, at


def pack_tables(cand: torch.Tensor, cand_n: torch.Tensor,
                dev_crc: torch.Tensor, is_server: torch.Tensor,
                link_dst: torch.Tensor,
                c_max: int) -> tuple[torch.Tensor, dict[str, int]]:
    """The tables the kernel reads, as one uint8 tensor in the layout of
    ``table_layout``, and its section offsets with the candidate count
    (``n_cands``).  A link's next-device code
    is ``2 * link_dst + is_server[link_dst]``: the walk learns where it
    is and whether it has arrived from one read, and the seed there from
    another."""
    row_off, ids = compact_candidates(cand, cand_n, c_max)
    nxt = (link_dst * 2 + is_server[link_dst]).to(torch.int16)
    offs, total = table_layout(dev_crc.numel(), row_off.numel() - 1,
                               link_dst.numel(), ids.numel())
    blob = torch.zeros(total, dtype=torch.uint8, device=cand.device)
    for name, t in (("crc", dev_crc), ("lcrc", dev_crc[link_dst]),
                    ("row", row_off), ("next", nxt), ("cand", ids)):
        b = t.contiguous().view(torch.uint8)
        blob[offs[name]:offs[name] + b.numel()] = b
    return blob, {**offs, "n_cands": ids.numel()}


def plan(n_links: int, n_devices: int, n_rows: int, n_cands: int) -> Plan:
    """The kernel instance and block for a fabric, by the shared-memory
    budget alone: the compact tables staged in shared memory beside
    ``WARPS`` load rows where they fit; else the instance that reads the
    tables from global memory, with as many rows (at most ``WARPS``) as
    fit.  Raises where not one row fits, or the ids overflow int16."""
    if n_links > _ID_MAX or 2 * n_devices - 1 > _ID_MAX:
        raise ValueError(f"{n_links} links, {n_devices} devices: the "
                         f"placement kernel's ids are int16")
    if n_rows >= _INT32_MAX or n_cands >= _INT32_MAX:
        raise ValueError(f"{n_rows} rows of {n_cands} candidates overflow "
                         f"the kernel's int32 offsets")

    def rows(w):
        return _align16(w * n_links * 8) + w * FIELD_BYTES

    tables = table_layout(n_devices, n_rows, n_links, n_cands)[1]
    if rows(WARPS) + tables <= SMEM_BUDGET:
        return Plan(True, WARPS, rows(WARPS) + tables)
    warps = max((w for w in range(1, WARPS + 1)
                 if rows(w) <= SMEM_BUDGET), default=0)
    if warps == 0:
        raise ValueError(f"a load row of {n_links} links does not fit in "
                         f"{SMEM_BUDGET} bytes of shared memory")
    return Plan(False, warps, rows(warps))


def chain_inputs(is_server: torch.Tensor, fields: torch.Tensor,
                 src_dev: torch.Tensor, dst_dev: torch.Tensor,
                 src_key: torch.Tensor, dst_key: torch.Tensor,
                 weight: torch.Tensor, order: torch.Tensor,
                 mask: torch.Tensor | None) -> tuple:
    """The per-flow inputs in placement order, as the kernel reads them:
    (N, 4) int32 ends (source, destination, the first hop's key — the
    source key at a server, else the destination key — and the later
    hops' key, the destination key: past its source a walk is never at
    a server), the weights and the (N, F) fields; and under a mask each
    seed's positions to place, int32 and seed-major, with (S + 1,)
    int64 offsets (``None, None`` without a mask)."""
    src, dkey = src_dev[order], dst_key[order]
    key0 = torch.where(is_server[src], src_key[order], dkey)
    ends = torch.stack([src, dst_dev[order], key0, dkey], 1).to(torch.int32)
    sel = sel_off = None
    if mask is not None:
        m = mask[order].t()                                   # (S, N)
        sel = m.nonzero()[:, 1].to(torch.int32)
        sel_off = torch.zeros(m.shape[0] + 1, dtype=torch.int64,
                              device=mask.device)
        sel_off[1:] = m.sum(1).cumsum(0)
    return (ends.contiguous(), weight[order].contiguous(),
            fields[order].contiguous(), sel, sel_off)


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
    if n >= _INT32_MAX:
        raise ValueError(f"{n} flows overflow the kernel's int32 positions")
    blob, offs = pack_tables(cand, cand_n, dev_crc, is_server, link_dst,
                             c_max)
    pl = plan(load.shape[1], dev_crc.numel(), cand_n.numel(), offs["n_cands"])
    ends, w_o, fields_o, sel, sel_off = chain_inputs(
        is_server, fields, src_dev, dst_dev, src_key, dst_key, weight,
        order, mask)
    fault = torch.full((s, 3), -1, dtype=torch.int64, device=dev)
    hops = torch.zeros(s, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().congestion_place(
            blob.data_ptr(), blob.numel(), offs["crc"], offs["lcrc"],
            offs["row"], offs["next"], offs["cand"], int(pl.shared_tables),
            pl.warps,
            pl.smem_bytes, fields_o.data_ptr(), fields.shape[1],
            seeds.data_ptr(), ends.data_ptr(), w_o.data_ptr(),
            order.data_ptr(), None if sel is None else sel.data_ptr(),
            None if sel_off is None else sel_off.data_ptr(),
            load.data_ptr(), link_ids.data_ptr(), fault.data_ptr(),
            hops.data_ptr(), n, s, num_keys, load.shape[1], max_hops,
            int(murmur), stream)
    if rc != 0:
        raise RuntimeError(
            f"congestion_place launch failed with CUDA error {rc}")
    LAUNCHES["congestion_place"] += 1
    return int(hops.max()) if s else 0, _fault(fault.cpu())
