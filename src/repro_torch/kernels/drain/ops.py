"""The departure-ordered max-min drain of event timing on the card.

``departure_drain`` drains every live (column, seed) cell's gigabits:
each round a max-min fill of the live cells, each cell's finish time
``rem / (rate x efficiency)``, the seed's earliest finish its horizon,
the cells within 1e-12 of it departing at ``t + finish`` and the others
draining for it — ``core.vector_throughput.departure_fill``'s loop.
Seeds never interact, so the kernel in ``csrc/drain.cu`` runs each
seed's whole drain in one cluster of CTAs over dense lists of its live
and free cells (``plan`` picks the cluster): one launch and one read of
its statistics, where the plain version launches dozens of ops and reads
the host once per freeze round.  A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version in ``ref.py``.
``LAUNCHES`` counts kernel launches (CPU calls never count).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from collections.abc import Callable

import torch

from . import build
from .ref import departure_drain_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"departure_drain": 0}
#: (library, device, cluster, chunks, links, cells a CTA) -> resident
#: clusters
_RESIDENT: dict = {}
#: dynamic shared memory one CTA may use on sm_90 (227 KB)
SMEM_BUDGET = 232_448
#: threads a CTA (``kThreads`` in the source)
THREADS = 512
#: CTAs a cluster may hold without the non-portable attribute
MAX_CLUSTER = 8
#: hops a cell may have: two 8-byte loads of four int16 links
MAX_HOPS = 8
#: SMs of an H100 SXM, the plan's default
SMS = 132
#: shared memory a link takes (its share in float64, an int32 stamp and
#: member count), the two tables of each warp's value in every CTA of a
#: cluster and three list lengths, and a cell's three uint16 list entries
LINK_BYTES, CELL_BYTES = 16, 6
FIXED_BYTES = 2 * MAX_CLUSTER * (THREADS // 32) * 8 + 16
#: a CTA's list offsets are uint16
MAX_CELLS_PER_BLOCK = 1 << 16
#: the fewest cells a CTA keeps when a seed spreads over more CTAs than
#: its lists need, and the largest cluster it spreads to: on an H100 at
#: ECMP's widest step (64 seeds x 4,096 cells) a cluster of 2 took 10.93
#: ms against 11.79 for 1, and over 16 seeds of prime-spray's (32,768
#: cells) 4 took 701 ms against 1,012 for 2 and 1,166 for 8
#: (``compare.py``)
MIN_CELLS_PER_BLOCK, MAX_SPREAD = 2_048, 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch shape: ``cluster`` CTAs a seed, ``chunks`` 4-hop loads a
    cell, list room for ``cells_per_block`` cells a CTA, and the
    ``smem_bytes`` of dynamic shared memory that takes."""

    cluster: int
    chunks: int
    cells_per_block: int
    smem_bytes: int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(n_links: int, cells_per_block: int) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in the source)."""
    return LINK_BYTES * n_links + FIXED_BYTES + CELL_BYTES * cells_per_block


def max_links() -> int:
    """The most links a fabric may have: a CTA holds its link rows beside
    lists for at least one cell a thread."""
    return (SMEM_BUDGET - FIXED_BYTES - CELL_BYTES * THREADS) // LINK_BYTES


def plan(n_seeds: int, cells: int, n_links: int, hops: int,
         sms: int = SMS, cluster: int | None = None,
         resident: Callable[[int, int], int] | None = None) -> Plan:
    """The launch shape for ``n_seeds`` seeds of at most ``cells`` cells
    over ``n_links`` links and ``hops`` hops a cell.

    A seed takes the smallest power-of-two cluster whose CTAs' lists
    hold its cells, then doubles it, up to ``MAX_SPREAD``, while each
    CTA keeps at least ``MIN_CELLS_PER_BLOCK`` cells and the card keeps
    every seed's cluster resident at once: ``resident(cluster,
    cells_per_block)`` clusters (the card's count, from the wrapper;
    by default ``sms // cluster``).  ``cluster`` forces a size instead.
    Raises where the hops, the links or the cells do not fit."""
    if hops > MAX_HOPS:
        raise ValueError(f"{hops} hops a cell: the drain kernel loads at "
                         f"most {MAX_HOPS}")
    if n_links > max_links():
        raise ValueError(f"{n_links} links do not fit one CTA's shared "
                         f"memory (at most {max_links()})")
    room = min(MAX_CELLS_PER_BLOCK,
               (SMEM_BUDGET - FIXED_BYTES - LINK_BYTES * n_links)
               // CELL_BYTES)

    def per_block(c):
        return -(-max(cells, 1) // c)

    if cluster is None:
        cluster = 1
        while per_block(cluster) > room and cluster < MAX_CLUSTER:
            cluster *= 2
        if resident is None:
            def resident(c, _):
                return sms // c
        while (2 * cluster <= MAX_SPREAD
               and per_block(2 * cluster) >= MIN_CELLS_PER_BLOCK
               and n_seeds <= resident(2 * cluster,
                                       per_block(2 * cluster))):
            cluster *= 2
    elif cluster not in (1, 2, 4, 8):
        raise ValueError(f"a cluster of {cluster} CTAs: the drain kernel "
                         f"takes 1, 2, 4 or {MAX_CLUSTER}")
    if per_block(cluster) > room:
        raise ValueError(
            f"{cells} cells a seed do not fit {cluster} CTAs' lists "
            f"({room} cells a CTA beside {n_links} links; at most "
            f"{MAX_CLUSTER * room} a seed)")
    cap = per_block(cluster)
    return Plan(cluster, 1 if hops <= 4 else 2, cap,
                smem_bytes(n_links, cap))


@dataclasses.dataclass
class Drain:
    """What a drain returns: ``done`` (A,) completion seconds per cell,
    the drain rounds (the most any seed ran), the freeze rounds of the
    fills (the plain version: summed over its rounds; the kernel: the
    most any seed ran) and, from the kernel only, the float64 operations
    its inputs need (``flops``), its longest seed's drain and freeze
    rounds together (``chain``) and, from a ``-DDRAIN_PROFILE`` build,
    the SM cycles of each phase summed over the seeds (``phases``: the
    fill's sums, shares, bottleneck pass, freeze pass, horizon,
    departures)."""

    done: torch.Tensor
    rounds: int
    fill_rounds: int
    flops: int | None = None
    chain: int | None = None
    phases: list | None = None


def departure_drain(cells: torch.Tensor, seed: torch.Tensor, n_seeds: int,
                    cap: torch.Tensor, gbits: torch.Tensor,
                    eff: torch.Tensor, w: torch.Tensor | None,
                    init: torch.Tensor | None, max_rounds: int, *,
                    cluster: int | None = None) -> Drain:
    """Drain ``A`` live cells of ``n_seeds`` seeds over ``L`` links.

    ``cells`` (H, A) int64 holds ``seed * L + link`` per hop (``S * L``
    for no link), ``seed`` (A,) int64 each cell's seed, non-decreasing;
    ``cap`` (L,), ``gbits`` (A,) > 0, ``eff`` (A,) and the optional
    weights ``w`` (A,) and round-1 rates ``init`` (A,) are float64.
    ``max_rounds`` guards the loop (a fault past it raises); ``cluster``
    forces the kernel's CTAs a seed (``plan``)."""
    H, A = cells.shape
    if cells.dtype != torch.int64 or seed.dtype != torch.int64:
        raise TypeError(f"cells and seed must be int64, got {cells.dtype} "
                        f"and {seed.dtype}")
    for name, t in (("seed", seed), ("gbits", gbits), ("eff", eff),
                    ("w", w), ("init", init)):
        if t is not None and tuple(t.shape) != (A,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                             f"cells need ({A},)")
    dev = cells.device
    if dev.type == "cpu":
        return Drain(*departure_drain_ref(cells, seed, n_seeds, cap, gbits,
                                          eff, w, init, max_rounds))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S, L = int(n_seeds), cap.numel()
    f64 = torch.float64
    counts = torch.bincount(seed, minlength=S)
    # host reads before the launch: the plan's cells a seed, and below
    # whether every weight is one power of two
    per_seed = int(counts.max()) if A else 0
    lib = build.load()
    chunks = 1 if H <= 4 else 2

    def resident(c, cells_per_block):
        key = (lib._name, dev.index, c, chunks, L, cells_per_block)
        if key not in _RESIDENT:
            n = ctypes.c_int(0)
            with torch.cuda.device(dev):
                rc = lib.drain_resident_clusters(c, chunks, L,
                                                 cells_per_block,
                                                 ctypes.byref(n))
            _RESIDENT[key] = n.value if rc == 0 else 0
        return _RESIDENT[key]

    pl = plan(S, per_seed, L, H,
              torch.cuda.get_device_properties(dev).multi_processor_count,
              cluster, resident)
    if A == 0:
        return Drain(torch.zeros(0, dtype=f64, device=dev), 0, 0, 0, 0)
    links = torch.full((A, 4 * pl.chunks), -1, dtype=torch.int16,
                       device=dev)
    links[:, :H] = torch.where(cells < S * L, cells - seed * L, -1).t()
    seg = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=seg[1:])
    w0 = 1.0
    if w is not None:
        # one power-of-two weight: the kernel counts members exactly
        first, same = torch.stack([w[0], (w == w[0]).all().to(w.dtype)]
                                  ).tolist()
        if (same and math.frexp(first)[0] == 0.5
                and 2.0**-900 < first < 2.0**900):
            w, w0 = None, first
    args = [t.to(dtype=f64).contiguous() for t in (cap, gbits, eff)]
    opt = [None if t is None else t.to(dtype=f64).contiguous()
           for t in (w, init)]
    rem, rate, done = (torch.empty(A, dtype=f64, device=dev)
                       for _ in range(3))
    sums = torch.empty((S, 2, L), dtype=f64, device=dev)
    stats = torch.zeros((S, lib.drain_stats_cols()), dtype=torch.int64,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.departure_drain(
            links.data_ptr(), seg.data_ptr(), *(t.data_ptr() for t in args),
            *(0 if t is None else t.data_ptr() for t in opt),
            rem.data_ptr(), rate.data_ptr(), done.data_ptr(),
            sums.data_ptr(), stats.data_ptr(), int(max_rounds), w0, L, S,
            pl.cluster, pl.chunks, pl.cells_per_block, stream)
    if rc != 0:
        raise RuntimeError(f"departure_drain launch failed with CUDA "
                           f"error {rc} (plan {pl})")
    LAUNCHES["departure_drain"] += 1
    stats = stats.cpu()                    # the launch's one host read after
    fault = int(stats[:, 3].max())
    if fault == 1:
        raise RuntimeError(
            "departure_fill: active flow with zero goodput can never "
            "finish (zero-capacity bottleneck link?)")
    if fault:
        raise RuntimeError(
            "departure_fill failed to converge (rate degeneracy?)")
    return Drain(done, int(stats[:, 0].max()), int(stats[:, 1].max()),
                 int(stats[:, 2].sum()), int((stats[:, 0] + stats[:, 1]).max()),
                 stats[:, 4:].sum(0).tolist() or None)


def sync_probe_ms(pl: Plan, n_seeds: int, n_links: int,
                  iters: int = 20_000) -> float:
    """Device ms of one cluster-wide reduction (a warp minimum stored in
    every CTA, the barrier and each warp's minimum) at ``pl``'s launch
    shape over ``n_seeds`` seeds: ``drain_sync_probe`` timed with CUDA
    events over ``iters`` rounds, after a warm-up launch."""
    out = torch.zeros(1, dtype=torch.float64, device="cuda")
    fn = build.load().drain_sync_probe

    def run(n):
        rc = fn(n_seeds, pl.cluster, n_links, pl.cells_per_block, n,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"drain_sync_probe launch failed with CUDA "
                               f"error {rc}")

    run(16)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    run(iters)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters
