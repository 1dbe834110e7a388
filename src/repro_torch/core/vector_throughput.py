"""Batched progressive-filling max-min fairness on the card.

The PyTorch port of ``repro.core.vector_throughput``, the
departure-ordered drain of event timing (``departure_fill``) included.
The fill runs on the dense
``(H, N, S)`` link-id tensor with the reference's *parallel*
formulation of progressive filling: a (seed, link) cell is a bottleneck
as soon as its fair share ``residual / active demand`` equals the
bottleneck share of **every** flow crossing it, and all such local
bottlenecks freeze at once, so the round count is the depth of the
bottleneck dependency chain rather than the number of distinct rates.

Every round is whole-tensor work over the surviving flows of every seed
of the chunk at once (the reference's cache-sized seed blocks have no
meaning on the card):

* per-flow bottleneck shares are one gather + ``amin`` over the hop axis;
* the local-bottleneck test ``min over members == share`` is evaluated
  as "no member's bottleneck lies below the cell's share" — exactly the
  same set, since the cell's own share enters every member's minimum —
  by marking each cell a member undercuts, which needs no float atomics;
* frozen flows drain with ``index_add_`` of negatives, and the survivors
  are compacted out (a prefix sum: one read to the host per round).

Float drains on the card are atomics in run-dependent order, so
residuals (and the exact-equality freeze test that reads them) can
differ by ulps from run to run; max-min rates are unique, so the
allocation agrees with the reference to float drift.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.drain import ops as drain_ops
from .compile_fabric import CompiledFabric, compile_fabric
from .contracts import check_throughput, contracts_enabled
from .fabric import Fabric
from .flows import Flow, WorkloadDescription
from .reordering import (
    flowlet_exposure, reordering_efficiency, resolve_transport,
)
from .vector_sim import (
    FILL_BYTES_PER_CELL, SimSpec, VectorTraceResult, _UNSET, _as_int64,
    _is_plain_ecmp, _seed_chunks, _stats, _walk_inputs, _weights_or_none,
    normalize_seeds, resolve_flows, resolve_spec, seed_chunk_size,
    segment_reduce, simulate_paths,
)


def dedup_link_ids(link_ids: torch.Tensor) -> torch.Tensor:
    """Copy of an ``(H, N, S)`` link-id tensor with repeated links within
    one (flow, seed) path collapsed to a single entry (-1 elsewhere), so
    a flow crossing the same link twice is counted and drained once."""
    ids = link_ids.clone()
    for h in range(1, ids.shape[0]):
        dup = (ids[h][None] == ids[:h]).any(0)
        ids[h] = torch.where(dup & (ids[h] >= 0), -1, ids[h])
    return ids


def _split(mask: torch.Tensor, flag: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """(indices of the True entries of a 1-D ``mask``, indices of the
    False ones, each in order; ``flag`` read as a bool) with ONE read to
    the host: the True count and the flag cross together, and one prefix
    sum scatters every index to its place in the partition (``nonzero``
    would synchronise once per side)."""
    n = mask.numel()
    dev = mask.device
    csum = torch.cumsum(mask, 0)
    if n == 0:
        return csum, csum, flag is not None and bool(flag)
    head = (csum[-1:] if flag is None
            else torch.stack([csum[-1], flag.to(csum.dtype)]))
    kept, *raised = head.tolist()
    idx = torch.arange(n, device=dev)
    # a True entry goes to its rank among the Trues, a False one after
    # all Trues at its rank among the Falses
    order = torch.empty(n, dtype=torch.int64, device=dev)
    order[torch.where(mask, csum - 1, kept + idx - csum)] = idx
    return order[:kept], order[kept:], any(raised)


def _fill_block(cells: torch.Tensor, sentinel: int, cap: torch.Tensor,
                w: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """Progressive fill of one block of columns; returns the (C,) rates
    and the number of freeze rounds it took.

    ``cells``: (H, C) int64 cell ids (cell = seed * L + link),
    ``sentinel`` the past-the-end id for "no link at this hop",
    ``cap``: (sentinel,) float64 capacity per cell, ``w``: (C,) positive
    demand weights or ``None`` for unit demand.

    Weighted max-min: a cell's fair share is ``residual / member weight
    sum`` (share per unit demand) and a column's rate is its weight
    times its bottleneck share.  Emptiness is tracked by an exact member
    count beside the weight sum, which drifts by float epsilons as flows
    drain.  With ``w=None`` the weight sum *is* the member count, and the
    arithmetic is the reference's unweighted ``_fill_block``.

    The per-cell state is one (cells, 3) tensor — member count, weight
    sum, residual — so a round drains its frozen columns with one
    ``index_add_``; a round reads the host once (``_split``).
    """
    H, C = cells.shape
    SL = sentinel
    dev = cells.device
    f64 = torch.float64
    inf = float("inf")
    flat = cells.reshape(-1)
    mem = torch.bincount(flat, minlength=SL + 1).to(f64)
    wsum = mem if w is None else torch.bincount(
        flat, weights=w.expand(H, C).reshape(-1), minlength=SL + 1)
    state = torch.stack([mem, wsum, torch.cat([cap, cap.new_zeros(1)])], 1)
    del mem, wsum

    def shares():
        sh = torch.where(state[:, 0] > 0,
                         state[:, 2] / state[:, 1].clamp(min=1e-300), inf)
        sh[SL] = inf                       # sentinel must stay unroutable
        return sh

    share = shares()
    rates = torch.full((C,), inf, dtype=f64, device=dev)  # crossing no link
    aidx, _, _ = _split((cells < SL).any(0))
    s = cells[:, aidx]
    wa = None if w is None else w[aidx]
    rounds = 0
    while aidx.numel():
        rounds += 1
        sv = share[s]                      # (H, A)
        fm = sv.amin(0)                    # per-flow bottleneck share
        # cells some member's bottleneck undercuts are not local
        # bottlenecks; every other cell with members is
        undercut = torch.zeros(SL + 1, dtype=torch.bool, device=dev)
        undercut[torch.where(sv > fm, s, SL)] = True
        del sv
        undercut[SL] = True
        fz = (~undercut)[s].any(0)         # flow crosses a local bottleneck
        rate_a = fm if wa is None else wa * fm
        rates[aidx] = rate_a               # survivors' are rewritten later
        keep, froze, _ = _split(~fz)
        if keep.numel() == 0:              # everything froze: no survivors
            break                          # to drain for
        F = froze.numel()
        rate_f = rate_a[froze]             # drain the frozen flows
        drain = torch.stack([
            torch.full_like(rate_f, -1.0),
            torch.full_like(rate_f, -1.0) if wa is None else -wa[froze],
            -rate_f], 1)
        state.index_add_(0, s[:, froze].reshape(-1),
                         drain.expand(H, F, 3).reshape(H * F, 3))
        share = shares()
        s = s[:, keep]                     # compact to surviving flows
        aidx = aidx[keep]
        if wa is not None:
            wa = wa[keep]
    return rates, rounds


def batched_max_min(
    link_ids: torch.Tensor,
    link_gbps,
    *,
    assume_unique: bool = False,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Max-min fair rates (Gb/s) for an ``(H, N, S)`` link-id tensor, on
    the tensor's device; returns ``(N, S)`` float64 rates.

    ``link_ids[h, n, s]`` is the id of the h-th link flow ``n`` crosses
    under seed ``s`` (-1 past the end of the path); ``link_gbps`` maps
    link id -> capacity.  A flow crossing zero links gets ``inf``.
    ``weights`` optionally gives every column a positive demand weight
    (weighted max-min); ``None`` or all-ones is unit demand.
    ``assume_unique`` skips the within-path duplicate-link collapse,
    safe for walked paths, which are loop-free.
    """
    link_ids = torch.as_tensor(link_ids)
    if link_ids.dim() != 3:
        raise ValueError(
            f"link_ids must be (H, N, S), got {tuple(link_ids.shape)}")
    dev = link_ids.device
    if not assume_unique:
        link_ids = dedup_link_ids(link_ids)
    H, N, S = link_ids.shape
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=torch.float64, device=dev)
        if tuple(weights.shape) != (N,):
            raise ValueError(
                f"weights must be ({N},) to match link_ids columns, "
                f"got {tuple(weights.shape)}")
        if not bool((weights > 0).all()):
            raise ValueError("weights must be strictly positive")
        weights = _weights_or_none(weights)
    cap = torch.as_tensor(link_gbps, dtype=torch.float64, device=dev)
    if H == 0 or N == 0 or S == 0:
        return torch.full((N, S), float("inf") if H == 0 else 0.0,
                          dtype=torch.float64, device=dev)
    return _fill_seeds(link_ids, cap, weights)[0]


def _fill_seeds(link_ids: torch.Tensor, cap: torch.Tensor,
                weights: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """Fill every seed of a non-empty, duplicate-free (H, N, S) tensor
    at once; returns the (N, S) rates and the freeze rounds taken."""
    H, N, S = link_ids.shape
    L = cap.numel()
    # seed-major columns (col = s * N + n), the reference's layout
    SL = S * L
    off = torch.arange(S, device=link_ids.device, dtype=torch.int64)[:, None] * L
    ids = link_ids.to(torch.int64).transpose(1, 2)            # (H, S, N)
    cells = torch.where(ids >= 0, ids + off, SL).reshape(H, S * N)
    del ids
    w = None if weights is None else weights.repeat(S)
    rates, rounds = _fill_block(cells, SL, cap.repeat(S), w)
    return rates.reshape(S, N).T.contiguous(), rounds          # (N, S)


def max_min_rates(result: VectorTraceResult) -> torch.Tensor:
    """``(Nf, S)`` max-min rates of every column (flowlet) under every
    seed; each column's effective demand (``column_weights``) is its
    weight.  Aggregate per parent flow with ``flow_rates_from_flowlets``."""
    return batched_max_min(result.link_ids, result.compiled.link_gbps,
                           assume_unique=True,
                           weights=_weights_or_none(result.column_weights()))


def flow_rates_from_flowlets(result: VectorTraceResult,
                             flowlet_rates: torch.Tensor) -> torch.Tensor:
    """``(N, S)`` per-flow rates: the ``(Nf, S)`` column rates summed per
    parent (``result.flow_index``) — the same grouping
    (``vector_sim.segment_reduce``) the exposure model runs."""
    fi = result.flow_index
    if not result.is_multipath and bool(
            (fi == torch.arange(fi.numel(), device=fi.device)).all()):
        return flowlet_rates
    return segment_reduce(flowlet_rates, fi, result.num_flows, "sum", 0.0)


@dataclasses.dataclass
class DepartureFill:
    """Result of a departure-ordered max-min drain (``departure_fill``),
    as tensors on the link ids' device.

    ``completion[n, s]`` is the absolute time (seconds) at which tensor
    column ``n``'s bytes finish under seed ``s``; ``duration[s]`` is the
    completion time of the slowest column — the step's derived duration;
    ``rounds`` counts the drain rounds (one per distinct departure
    epoch, bounded by the column count) and ``fill_rounds`` the freeze
    rounds of the re-fills those rounds ran (on the CPU summed over the
    rounds; on the card the most any one seed ran).
    """

    completion: torch.Tensor             # (Nf, S) seconds per column
    duration: torch.Tensor               # (S,) slowest-column completion
    rounds: int
    fill_rounds: int = 0


def departure_fill(
    link_ids: torch.Tensor,
    link_gbps,
    col_gbits,
    *,
    weights=None,
    efficiency=None,
    assume_unique: bool = False,
    initial_rates=None,
    device=None,
) -> DepartureFill:
    """Water-filling with departures over an ``(H, N, S)`` link-id tensor,
    on ``device`` (the card unless ``"cpu"``; ``link_ids`` moves there).

    Every column ``n`` carries ``col_gbits[n]`` gigabits.  All columns
    start draining at their max-min rate (weighted by ``weights`` exactly
    like ``max_min_rates``); the earliest-finishing cells *depart* and
    the survivors' rates are re-filled over the **same** paths with the
    departed (column, seed) cells gone, so tail flows speed up as
    elephants drain.  Seeds progress independently (each has its own
    departure order) while every round fills all surviving cells of all
    seeds at once.

    The live (column, seed) cells go to the drain in the fill's
    seed-major order, with their remaining gigabits, goodput multiplier
    and weight (``kernels/drain``): on the card every seed's whole drain
    is one cluster of CTAs of one kernel launch, on the CPU the plain
    version runs the reference's rounds over all seeds at once.

    ``efficiency`` optionally scales each cell's drain rate (goodput =
    rate x efficiency), held fixed across re-fills.  ``initial_rates``
    (the full-set fill a caller already ran) is reused as round 1, and
    only trusted when every column starts active.  Zero-gigabit columns
    complete at t=0 and never contend; columns that cross no links drain
    at infinite rate and also complete at t=0.  Times are seconds for
    ``col_gbits`` in gigabits and ``link_gbps`` in Gb/s (``bytes * 8e-9``
    converts).
    """
    dev = resolve_device(device)
    link_ids = torch.as_tensor(link_ids).to(dev)
    if link_ids.dim() != 3:
        raise ValueError(
            f"link_ids must be (H, N, S), got {tuple(link_ids.shape)}")
    f64 = torch.float64
    if not assume_unique:
        link_ids = dedup_link_ids(link_ids)
    H, N, S = link_ids.shape
    gb = torch.as_tensor(col_gbits, dtype=f64, device=dev)
    if tuple(gb.shape) != (N,):
        raise ValueError(
            f"col_gbits must be ({N},) to match link_ids columns, "
            f"got {tuple(gb.shape)}")
    if not bool(((gb >= 0) & torch.isfinite(gb)).all()):
        raise ValueError("col_gbits must be finite and >= 0")
    if efficiency is None:
        eff = torch.ones((N, S), dtype=f64, device=dev)
    else:
        eff = torch.as_tensor(efficiency, dtype=f64, device=dev)
        if tuple(eff.shape) != (N, S):
            raise ValueError(
                f"efficiency must be ({N}, {S}), got {tuple(eff.shape)}")
        if not bool(((eff > 0) & torch.isfinite(eff)).all()):
            raise ValueError("efficiency must be finite and > 0")
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=f64, device=dev)
        if tuple(weights.shape) != (N,):
            raise ValueError(
                f"weights must be ({N},) to match link_ids columns, "
                f"got {tuple(weights.shape)}")
        if not bool((weights > 0).all()):
            raise ValueError("weights must be strictly positive")
        weights = _weights_or_none(weights)
    completion = torch.zeros((N, S), dtype=f64, device=dev)
    if N == 0 or S == 0 or H == 0:
        return DepartureFill(completion=completion,
                             duration=torch.zeros(S, dtype=f64, device=dev),
                             rounds=0)
    cap = torch.as_tensor(link_gbps, dtype=f64, device=dev)
    L = cap.numel()
    SL = S * L
    # every (column, seed) cell in the fill's seed-major order
    seed = torch.arange(S, device=dev).repeat_interleave(N)
    col = torch.arange(N, device=dev).repeat(S)
    ids = link_ids.to(torch.int64).transpose(1, 2).reshape(H, S * N)
    live, _, _ = _split(gb[col] > 0.0)     # zero-gigabit cells never contend
    seed, col = seed[live], col[live]
    cells = torch.where(ids[:, live] >= 0, ids[:, live] + seed * L, SL)
    del ids
    rem = gb[col]
    eff_c = eff[col, seed]
    w_c = None if weights is None else weights[col]
    init = None
    if initial_rates is not None and live.numel() == S * N:
        init = torch.as_tensor(initial_rates, dtype=f64, device=dev)
        if tuple(init.shape) != (N, S):
            raise ValueError(
                f"initial_rates must be ({N}, {S}), got {tuple(init.shape)}")
        init = init[col, seed]
    drain = drain_ops.departure_drain(cells, seed, S, cap, rem, eff_c, w_c,
                                      init, N + 1)
    completion.view(-1)[col * S + seed] = drain.done
    return DepartureFill(completion=completion,
                         duration=completion.amax(0), rounds=drain.rounds,
                         fill_rounds=drain.fill_rounds)


@dataclasses.dataclass
class MonteCarloThroughput:
    """Per-flow and per-pair max-min rate distributions over a seed sweep
    (device tensors).

    ``rates`` is the max-min allocation; ``goodput`` is ``rates x
    efficiency`` under the ``transport`` profile.  Where the exposure
    pass is skipped (``ideal`` transport, plain ECMP's seed-chunked
    sweep, whose flows have zero exposure) ``goodput`` is a copy of
    ``rates`` (never an alias)."""

    seeds: np.ndarray                    # (S,)
    flows: list[Flow]
    rates: torch.Tensor                  # (N, S) Gb/s per flow per seed
    pairs: list[tuple[str, str]]         # (src, dst) in first-seen order
    per_pair: torch.Tensor               # (P, S) Gb/s per pair per seed
    transport: str = "ideal"             # reordering profile name
    exposure: torch.Tensor | None = None   # (N, S) out-of-order exposure
    efficiency: torch.Tensor | None = None  # (N, S) goodput multiplier
    goodput: torch.Tensor | None = None    # (N, S) effective Gb/s per flow
    seed_chunk: int = 0                  # seeds per device pass
    fill_rounds: int = 0                 # most freeze rounds of any chunk

    def __post_init__(self):
        if self.exposure is None:
            self.exposure = torch.zeros_like(self.rates)
        if self.efficiency is None:
            self.efficiency = torch.ones_like(self.rates)
        if self.goodput is None:
            self.goodput = self.rates.clone()

    @property
    def num_seeds(self) -> int:
        return len(self.seeds)

    def pair_throughput_for_seed(
        self, seed_index: int
    ) -> dict[tuple[str, str], float]:
        """One seed's pair throughputs in ``per_pair_throughput`` format
        (the seed's column read to the host in one copy)."""
        col = self.per_pair[:, seed_index].tolist()
        return dict(zip(self.pairs, col))

    def summary(self) -> dict[str, dict[str, float]]:
        per_pair = self.per_pair.cpu().numpy()
        rows = {
            "flow_rate": self.rates.cpu().numpy(),
            "flow_goodput": self.goodput.cpu().numpy(),
            "pair_total": per_pair,
            "pair_min": per_pair.min(axis=0),
            "pair_median": np.median(per_pair, axis=0),
        }
        return {name: _stats(np.asarray(v, np.float64).ravel())
                for name, v in rows.items()}


def pair_rate_matrix(
    flows: Sequence[Flow], rates: torch.Tensor
) -> tuple[list[tuple[str, str]], torch.Tensor]:
    """Aggregate ``(N, S)`` flow rates into ``(P, S)`` per-pair totals.

    Pairs are ordered by first appearance in ``flows``.  The grouping is
    per flow and runs on the host; the sum runs on the rates' device
    (``index_add_``: atomics on the card, so run-dependent order)."""
    pair_index: dict[tuple[str, str], int] = {}
    idx = np.empty(len(flows), np.int64)
    for j, f in enumerate(flows):
        idx[j] = pair_index.setdefault((f.src, f.dst), len(pair_index))
    per_pair = torch.zeros((len(pair_index), rates.shape[1]),
                           dtype=torch.float64, device=rates.device)
    per_pair.index_add_(0, torch.from_numpy(idx).to(rates.device), rates)
    return list(pair_index), per_pair


def throughput_from_result(
    result: VectorTraceResult,
    *,
    transport=None,
    flowlet_rates: torch.Tensor | None = None,
) -> MonteCarloThroughput:
    """Rate distributions for an already-simulated ``VectorTraceResult``.

    Multi-path results fill over flowlet columns and sum rates per parent
    flow, so ``rates`` is always ``(N, S)`` over ``result.flows``.
    ``transport`` names the reordering profile (``None`` = ``ideal``):
    flowlet exposure comes from the same fill (``flowlet_exposure``, with
    any ``extra_exposure`` the strategy charged) and ``goodput = rates x
    efficiency``.  A profile with ``alpha == 0`` or ``floor == 1`` makes
    every efficiency 1, so the exposure pass is skipped (``.exposure``
    reads 0).  ``flowlet_rates`` optionally supplies a precomputed
    ``max_min_rates(result)``."""
    profile = resolve_transport(transport)
    if flowlet_rates is None:
        flowlet_rates = max_min_rates(result)
    rates = flow_rates_from_flowlets(result, flowlet_rates)
    pairs, per_pair = pair_rate_matrix(result.flows, rates)
    tp = MonteCarloThroughput(seeds=result.seeds, flows=result.flows,
                              rates=rates, pairs=pairs, per_pair=per_pair,
                              transport=profile.name)
    if profile.alpha != 0.0 and profile.floor != 1.0:
        tp.exposure = flowlet_exposure(result, flowlet_rates)
        tp.efficiency = reordering_efficiency(tp.exposure, profile)
        tp.goodput = rates * tp.efficiency
    if contracts_enabled():
        check_throughput(tp)
    return tp


def monte_carlo_throughput(
    fabric: Fabric | CompiledFabric,
    workload: WorkloadDescription | Sequence[Flow],
    seeds: Sequence[int] | np.ndarray,
    *,
    spec: SimSpec | None = None,
    fields=_UNSET,
    hash_backend=_UNSET,
    field_matrix: np.ndarray | None = None,
    strategy=_UNSET,
    demand_mode=_UNSET,
    transport=_UNSET,
    device=_UNSET,
    max_hops=_UNSET,
) -> MonteCarloThroughput:
    """Max-min throughput distribution of a routing strategy across a
    seed sweep.

    Same front-end contract as ``monte_carlo_fim``; ``demand_mode=
    "bytes"`` allocates weighted max-min shares and ``transport`` names
    the reordering profile.  Plain ECMP walks and fills each seed chunk
    (sized from free device memory, ``seed_chunk_size``) before the next
    starts and keeps only its (N, chunk) rates; its flows have zero
    exposure, so goodput equals rates under every profile.  Every other
    strategy routes and fills the whole seed list in one pass and prices
    its flowlets' reordering (``throughput_from_result``).
    """
    s = resolve_spec(spec, dict(
        fields=fields, hash_backend=hash_backend, strategy=strategy,
        demand_mode=demand_mode, transport=transport, device=device,
        max_hops=max_hops))
    comp = fabric if isinstance(fabric, CompiledFabric) else compile_fabric(fabric)
    flows = resolve_flows(comp, workload)
    seeds_u64 = normalize_seeds(seeds)
    tabs = comp.to(s.device)
    if not _is_plain_ecmp(s.strategy):
        res = simulate_paths(comp, flows, seeds_u64, spec=s,
                             field_matrix=field_matrix)
        flowlet_rates, rounds = _fill_seeds(
            res.link_ids, tabs.link_gbps,
            _weights_or_none(res.column_weights()))
        tp = throughput_from_result(res, transport=s.transport,
                                    flowlet_rates=flowlet_rates)
        tp.seed_chunk, tp.fill_rounds = len(seeds_u64), rounds
        return tp
    inp = _walk_inputs(comp, flows, s, field_matrix)
    weights = _weights_or_none(inp.flow_demand)
    seeds_t = _as_int64(seeds_u64, s.device)
    N, S = len(flows), len(seeds_u64)
    chunk = seed_chunk_size(N, S, FILL_BYTES_PER_CELL, s.device)
    rates = torch.empty((N, S), dtype=torch.float64, device=s.device)
    rounds = 0
    for s0, s1 in _seed_chunks(S, chunk):
        ids = inp.walk(comp, seeds_t[s0:s1], s)
        rates[:, s0:s1], r = _fill_seeds(ids, tabs.link_gbps, weights)
        rounds = max(rounds, r)
        del ids
    pairs, per_pair = pair_rate_matrix(flows, rates)
    return MonteCarloThroughput(
        seeds=seeds_u64, flows=flows, rates=rates, pairs=pairs,
        per_pair=per_pair, transport=resolve_transport(s.transport).name,
        seed_chunk=chunk, fill_rounds=rounds)
