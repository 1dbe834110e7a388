"""Pluggable routing strategies over the compiled-fabric candidate tables.

The port's own copy of ``repro.core.strategies``, function by function.
A strategy turns (compiled fabric, flows, seeds) into a
``VectorTraceResult``; multi-path strategies emit flowlet columns with
``flow_index`` / ``demand`` metadata, which the demand-weighted link
loads, the weighted max-min fill and the reordering exposure aggregate
back per parent flow.

* ``EcmpStrategy`` — per-flow ECMP, the front ends' default walk;
* ``PrimeSpraying`` — PRIME-style multi-part-entropy spraying
  (arXiv 2507.23012): K flowlets per flow, each with its mixed-radix
  entropy digits appended to the hash fields; ``min_bytes`` sprays
  only elephants (``volume_k``: K proportional to the bytes);
* ``AdaptiveSpraying`` — PRIME's per-RTT entropy re-pick: congested
  flowlets re-walk with a fresh salt and keep a path that is cooler;
* ``CongestionAware`` — greedy least-loaded placement, one flow at a
  time (cf. arXiv 2506.08132);
* ``WaveCongestionAware`` — the same greedy rule as speculate-then-
  repair rounds over every (flow, seed) cell at once.

Every walk on the device goes through ``vector_sim.ecmp_walk`` or the
wave walk below, whose per-hop hash is ``hash_grid`` (the murmur kernel
on the card under ``"murmur"``).  Unsigned 64-bit arithmetic (the
splitmix64 coins, the round constants, ``hash % n_tie``) lives in int64
as in ``vector_sim``.

Link loads sum the cells of an ``(H, N, S)`` tensor into (seed, link)
bins in C order, the reference's ``np.bincount`` order, so every float
decision (adaptive marking and acceptance) is bit-identical to it, and
link ids on the card equal the CPU's under every demand mode: on the
card every such sum is one launch of the ordered-sum kernel
(``kernels/loads``), which adds each bin's cells in that order.

The sequential placement chain (``_sequential_congestion_place``) reads,
for each flow, the loads the earlier flows wrote, but only under its own
seed: the seeds are independent chains.  On the card the whole chain is
one launch of the placement kernel (``kernels/placement``), a warp per
seed with its load row and the fabric's compact tables in shared
memory, hashing ties with the kernel's own murmur or exact fold; loads,
masks and paths stay on the card.  Its per-seed sums run in flow order,
the host loop's, so its link ids are the CPU's bit for bit under any
weights.  On the CPU the kernel's plain version runs the reference's
numpy loop.

The built-in strategies sit in a port-local registry (a dict literal);
``register_strategy`` adds more and raises on a duplicate name.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Callable, Sequence

import numpy as np
import torch

from ..kernels.loads import ops as loads
from ..kernels.placement import ops as placement
from .compile_fabric import CompiledFabric
from .ecmp import FIELDS_5TUPLE
from .flows import Flow
from .vector_sim import (
    DEMAND_UNIFORM, MURMUR, SimSpec, VectorTraceResult, _as_int64, _mix64,
    _srl, _u64, _umod, ecmp_walk, flow_demand_weights, hash_grid,
)
from .vector_sim import _walk_inputs as _flow_walk_inputs

_MASK64 = 0xFFFFFFFFFFFFFFFF
_INT64_MAX = torch.iinfo(torch.int64).max


class RoutingStrategy:
    """Interface: turn (compiled fabric, flows, seeds) into routed paths.

    ``route`` receives the normalized inputs from ``simulate_paths`` and
    returns a ``VectorTraceResult`` on ``device`` whose flowlet
    ``demand`` fractions sum to 1 per parent flow, carrying the
    ``demand_mode``-derived per-flow weights in ``flow_demand``.
    """

    #: registry name; instances may be configured, the name is the family
    name: str = "?"

    def route(
        self,
        comp: CompiledFabric,
        flows: list[Flow],
        seeds_u64: np.ndarray,
        *,
        fields: str = FIELDS_5TUPLE,
        hash_backend: str | None = None,
        max_hops: int = 16,
        field_matrix: np.ndarray | None = None,
        demand_mode: str = DEMAND_UNIFORM,
        device=None,
    ) -> VectorTraceResult:
        raise NotImplementedError


class EcmpStrategy(RoutingStrategy):
    """Per-flow ECMP — the baseline, the front ends' default walk."""

    name = "ecmp"

    def route(self, comp, flows, seeds_u64, *, fields=FIELDS_5TUPLE,
              hash_backend=None, max_hops=16, field_matrix=None,
              demand_mode=DEMAND_UNIFORM, device=None):
        from .vector_sim import simulate_paths
        return simulate_paths(comp, flows, seeds_u64, fields=fields,
                              hash_backend=hash_backend, max_hops=max_hops,
                              field_matrix=field_matrix,
                              demand_mode=demand_mode, device=device)


def _balanced_parts(k: int) -> tuple[int, ...]:
    """Default multi-part split of K flowlets: the most balanced two-factor
    decomposition (8 -> (2, 4)); prime or unit K stays single-part."""
    for a in range(int(np.sqrt(k)), 1, -1):
        if k % a == 0:
            return (a, k // a)
    return (k,)


#: default elephant threshold for demand-aware spraying: 64 MiB
ELEPHANT_MIN_BYTES = 64 * 1024 * 1024


def _walk_inputs(comp, flows, seeds_u64, fields, field_matrix, hash_backend,
                 max_hops, device):
    """(resolved spec, the flow table's walk inputs on its device, the
    seeds as an int64 tensor there)."""
    s = SimSpec(fields=fields, hash_backend=hash_backend, max_hops=max_hops,
                device=device).resolve()
    return s, _flow_walk_inputs(comp, flows, s, field_matrix), _as_int64(
        seeds_u64, s.device)


class PrimeSpraying(RoutingStrategy):
    """PRIME-style multi-part-entropy packet spraying (arXiv 2507.23012).

    Each flow is split into up to ``flowlets`` equal-demand flowlets;
    flowlet ``k``'s entropy label is the mixed-radix digit vector of
    ``k`` over ``parts`` (product must equal ``flowlets``), appended to
    the flow's hash fields as extra columns.  With ``flowlets=1`` no
    label is appended and the walk is ECMP's.

    ``min_bytes`` sprays only flows with ``Flow.bytes >= min_bytes``;
    the rest walk label-free and stay on their ECMP paths.
    ``volume_k=True`` makes ``min_bytes`` the target bytes per flowlet:
    each flow splits into ``clip(ceil(bytes / min_bytes), 1, flowlets)``
    flowlets.  ``min_bytes`` reads raw ``Flow.bytes``, independent of
    ``demand_mode``.
    """

    name = "prime-spray"

    def __init__(self, flowlets: int = 8,
                 parts: Sequence[int] | None = None,
                 min_bytes: float | None = None,
                 volume_k: bool = False):
        if flowlets < 1:
            raise ValueError(f"flowlets must be >= 1, got {flowlets}")
        self.flowlets = int(flowlets)
        self.parts = (tuple(int(p) for p in parts) if parts is not None
                      else _balanced_parts(self.flowlets))
        if any(p < 1 for p in self.parts):
            raise ValueError(f"entropy parts must be >= 1: {self.parts}")
        if int(np.prod(self.parts)) != self.flowlets:
            raise ValueError(
                f"entropy parts {self.parts} do not multiply to "
                f"{self.flowlets} flowlets")
        if min_bytes is not None and not min_bytes > 0:
            raise ValueError(f"min_bytes must be > 0, got {min_bytes}")
        if volume_k and min_bytes is None:
            raise ValueError(
                "volume_k needs min_bytes (the target bytes per flowlet)")
        self.min_bytes = min_bytes
        self.volume_k = bool(volume_k)

    def entropy_labels(self) -> np.ndarray:
        """(K, P) uint64 mixed-radix digits, one row per flowlet."""
        k = np.arange(self.flowlets, dtype=np.uint64)
        cols = []
        for base in self.parts:
            cols.append(k % np.uint64(base))
            k = k // np.uint64(base)
        return np.stack(cols, axis=1)

    def flowlet_counts(self, flows: Sequence[Flow]) -> np.ndarray:
        """(N,) int64 flowlets per flow under the demand-aware policy."""
        n = len(flows)
        if self.min_bytes is None:
            return np.full(n, self.flowlets, np.int64)
        b = np.array([f.bytes for f in flows], np.float64)
        if self.volume_k:
            # ceil: one flowlet per started min_bytes chunk
            with np.errstate(invalid="ignore"):   # min_bytes=inf: b/inf -> 0
                k = np.ceil(b / self.min_bytes)
            return np.clip(np.nan_to_num(k), 1, self.flowlets).astype(np.int64)
        return np.where(b >= self.min_bytes, self.flowlets, 1).astype(np.int64)

    def _layout(self, flows):
        """(k_f, flow_index, local flowlet index) of the flowlet columns,
        as host arrays."""
        k_f = self.flowlet_counts(flows)
        flow_index = np.repeat(np.arange(len(flows), dtype=np.int64), k_f)
        starts = np.concatenate(([0], np.cumsum(k_f)[:-1]))
        local = (np.arange(flow_index.size, dtype=np.int64)
                 - np.repeat(starts, k_f))
        return k_f, flow_index, local

    def _walker(self, comp, flows, spec, inp, seeds, flow_index, local):
        """``walk(cols, with_labels, cell_salt=None, what="flowlet")``:
        the ECMP walk of the flowlet columns ``cols`` (host indices)."""
        dev = spec.device
        labels = _as_int64(self.entropy_labels(), dev)
        ends = (inp.src_dev, inp.dst_dev, inp.src_key, inp.dst_key)

        def walk(cols, with_labels, cell_salt=None, what="flowlet"):
            idx = torch.from_numpy(flow_index[cols]).to(dev)
            f = inp.fields[idx]
            if with_labels:
                f = torch.cat([f, labels[torch.from_numpy(
                    local[cols]).to(dev)]], 1).contiguous()
            return ecmp_walk(
                comp, *(e[idx] for e in ends), f, seeds,
                hash_backend=spec.hash_backend, max_hops=spec.max_hops,
                cell_salt=cell_salt, device=dev,
                describe=lambda j: (
                    f"flow {flows[int(flow_index[cols[int(j)]])].flow_id} "
                    f"{what} {int(local[cols[int(j)]])}"))
        return walk

    def route(self, comp, flows, seeds_u64, *, fields=FIELDS_5TUPLE,
              hash_backend=None, max_hops=16, field_matrix=None,
              demand_mode=DEMAND_UNIFORM, device=None):
        return self._spray(comp, flows, seeds_u64, fields, hash_backend,
                           max_hops, field_matrix, demand_mode, device)[0]

    def _spray(self, comp, flows, seeds_u64, fields, hash_backend, max_hops,
               field_matrix, demand_mode, device):
        """(the static spray's result, its walker, its column layout,
        the seeds on its device)."""
        n = len(flows)
        if (self.min_bytes is not None and np.isfinite(self.min_bytes)
                and n and all(f.bytes == 0 for f in flows)):
            # an explicit finite threshold against a volume-less workload
            # is almost certainly a mistake: every flow stays single-path
            # and the "spraying" comparison silently measures plain ECMP
            warnings.warn(
                f"{self.name}: min_bytes={self.min_bytes:g} but every "
                f"Flow.bytes is 0 (workload carries no volumes) — no flow "
                f"sprays, this is ECMP", stacklevel=3)
        spec, inp, seeds = _walk_inputs(comp, flows, seeds_u64, fields,
                                        field_matrix, hash_backend, max_hops,
                                        device)
        layout = k_f, flow_index, local = self._layout(flows)
        total = flow_index.size
        walk = self._walker(comp, flows, spec, inp, seeds, flow_index, local)
        sprayed = k_f[flow_index] > 1          # per column
        every = np.arange(total, dtype=np.int64)
        if sprayed.all():
            link_ids = walk(every, with_labels=True)
        elif not sprayed.any():
            # nothing crosses the elephant bar (or flowlets=1): one
            # label-free walk, ECMP's
            link_ids = walk(every, with_labels=False)
        else:
            # mixed: sprayed columns walk with entropy labels, unsprayed
            # flows walk label-free, then the two interleave back into
            # parent order
            p_cols, u_cols = np.flatnonzero(sprayed), np.flatnonzero(~sprayed)
            p_ids = walk(p_cols, with_labels=True)
            u_ids = walk(u_cols, with_labels=False)
            hops = max(p_ids.shape[0], u_ids.shape[0])
            link_ids = torch.full((hops, total, len(seeds_u64)), -1,
                                  dtype=torch.int32, device=spec.device)
            for cols, ids in ((p_cols, p_ids), (u_cols, u_ids)):
                link_ids[:ids.shape[0],
                         torch.from_numpy(cols).to(spec.device)] = ids
        res = VectorTraceResult(
            compiled=comp, flows=list(flows), seeds=seeds_u64,
            link_ids=link_ids, flow_index=flow_index,
            demand=np.repeat(1.0 / k_f, k_f), strategy=self.name,
            flow_demand=flow_demand_weights(flows, demand_mode))
        return res, walk, layout, seeds


def _cell_loads(link_ids: torch.Tensor, weights: torch.Tensor,
                num_links: int) -> torch.Tensor:
    """(S, L) demand-weighted link loads of an ``(H, N, S)`` tensor,
    ``-1`` skipped: each (seed, link) bin sums its cells' weights in C
    order, the reference's ``np.bincount`` order, bit for bit on either
    device, for any weights (``loads.ordered_cell_sum``: the kernel on
    the card, ``torch.bincount`` on the CPU)."""
    return loads.ordered_cell_sum(link_ids.contiguous(),
                                  weights.contiguous(), num_links)


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sums along the last axis in numpy's pairwise order (blocks of at
    most 128 summed by 8 accumulators, larger runs halved at a multiple
    of 8), so that a float sum equals ``x.sum(axis=-1)`` of the
    reference bit for bit on either device."""
    n = x.shape[-1]
    if n < 8:
        r = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            r = r + x[..., i]
        return r
    if n <= 128:
        m = n - n % 8
        r = x[..., :8]
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(m, n):
            res = res + x[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _row_sum(x[..., :n2]) + _row_sum(x[..., n2:])


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 of uint64 bits held in int64: a stateless mixer for the
    coin flips (deterministic in the cell/seed/round coordinates)."""
    return _mix64(x + _u64(0x9E3779B97F4A7C15))


def _path_max_load(link_ids: torch.Tensor, loads: torch.Tensor) -> torch.Tensor:
    """(C, S) hottest-link load along each column's path, given (S, L)
    link loads.  Link-free columns read 0 (they queue nowhere)."""
    S, L = loads.shape
    if link_ids.shape[0] == 0:
        return torch.zeros(link_ids.shape[1:], dtype=loads.dtype,
                           device=loads.device)
    live = link_ids >= 0
    cells = link_ids.to(torch.int64) + torch.arange(
        S, device=loads.device, dtype=torch.int64) * L
    vals = torch.where(live, loads.reshape(-1)[torch.where(live, cells, 0)],
                       0.0)
    return vals.amax(0)


class AdaptiveSpraying(PrimeSpraying):
    """PRIME's adaptive mode: per-RTT entropy re-pick under congestion
    feedback (arXiv 2507.23012).

    ``rounds`` RTTs on top of the ``PrimeSpraying`` round-0 allocation:

    1. **feedback**: demand-weighted link loads of the current paths,
       per seed; a flowlet is *marked* when its path's hottest link
       carries more than ``ecn_factor`` x that seed's mean loaded-link
       load;
    2. **re-pick**: each marked (flowlet, seed) cell re-picks with
       probability ``move_prob`` (a splitmix64 coin keyed on cell, seed
       and round) and walks with a fresh entropy salt against the frozen
       loads;
    3. **accept**: the move is kept only when the candidate's hottest
       link plus the flowlet's own demand undercuts its current path's
       hottest link.

    Unmarked cells keep their salt, so their walks replay bit for bit,
    and ``rounds=1`` is ``PrimeSpraying`` wholesale.  Each accepted move
    is charged ``respray_cost`` x the flowlet's demand fraction in
    ``VectorTraceResult.extra_exposure``.
    """

    name = "adaptive-spray"

    def __init__(self, flowlets: int = 8,
                 parts: Sequence[int] | None = None,
                 min_bytes: float | None = None,
                 volume_k: bool = False,
                 rounds: int = 4,
                 ecn_factor: float = 1.25,
                 respray_cost: float = 0.05,
                 move_prob: float = 0.25):
        super().__init__(flowlets, parts, min_bytes=min_bytes,
                         volume_k=volume_k)
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        if not ecn_factor > 0:
            raise ValueError(f"ecn_factor must be > 0, got {ecn_factor}")
        if respray_cost < 0:
            raise ValueError(
                f"respray_cost must be >= 0, got {respray_cost}")
        if not 0.0 < move_prob <= 1.0:
            raise ValueError(
                f"move_prob must be in (0, 1], got {move_prob}")
        self.rounds = int(rounds)
        self.ecn_factor = float(ecn_factor)
        self.respray_cost = float(respray_cost)
        self.move_prob = float(move_prob)

    def with_rounds(self, rounds: int) -> "AdaptiveSpraying":
        """A copy of this strategy with a different round budget — every
        other knob unchanged."""
        if rounds == self.rounds:
            return self
        return AdaptiveSpraying(
            self.flowlets, self.parts, min_bytes=self.min_bytes,
            volume_k=self.volume_k, rounds=rounds,
            ecn_factor=self.ecn_factor, respray_cost=self.respray_cost,
            move_prob=self.move_prob)

    def route(self, comp, flows, seeds_u64, *, fields=FIELDS_5TUPLE,
              hash_backend=None, max_hops=16, field_matrix=None,
              demand_mode=DEMAND_UNIFORM, device=None):
        res, walk, (k_f, flow_index, _), seeds = self._spray(
            comp, flows, seeds_u64, fields, hash_backend, max_hops,
            field_matrix, demand_mode, device)
        if self.rounds == 1 or not res.is_multipath:
            return res                     # static spray / ECMP degenerate
        dev, s = res.link_ids.device, len(seeds_u64)
        spray_cols = np.flatnonzero(k_f[flow_index] > 1)
        spray = torch.from_numpy(spray_cols).to(dev)
        col_w = res.column_weights()
        w_col = col_w[spray][:, None]              # (C, 1)
        link_ids = res.link_ids
        salt = torch.zeros((spray.numel(), s), dtype=torch.int64, device=dev)
        probe = torch.zeros_like(salt)
        resprays = torch.zeros((spray.numel(), s), dtype=torch.float64,
                               device=dev)
        # per-cell coin identity: decorrelated across flowlets and seeds,
        # re-mixed with the round index below so each round flips fresh
        cell_id = _splitmix64(spray)[:, None] ^ seeds[None, :]
        p_bits = int(self.move_prob * 2.0 ** 53)
        rounds = 0
        for rnd in range(self.rounds - 1):
            loads = _cell_loads(link_ids, col_w, comp.num_links)
            cur = link_ids[:, spray]
            path_max = _path_max_load(cur, loads)
            mean_load = _row_sum(loads) / (loads > 0).sum(1).clamp(min=1)
            marked = path_max > self.ecn_factor * mean_load[None, :]
            if not bool(marked.any()):
                break
            rounds = rnd + 1
            # herd damping: every marked cell re-picks only with
            # probability move_prob per round
            coin = _splitmix64(
                cell_id ^ _u64((rnd + 1) * 0xD1B54A32D192ED03 & _MASK64))
            marked &= _srl(coin, 11) < p_bits
            if not bool(marked.any()):
                continue
            probe = probe + marked                  # fresh salt per probe
            cand = walk(spray_cols, True, torch.where(marked, probe, salt),
                        "respray flowlet")
            cand_max = _path_max_load(cand, loads)
            accept = marked & (cand_max + w_col < path_max)
            if not bool(accept.any()):
                continue
            salt = torch.where(accept, probe, salt)
            resprays += accept
            hops = max(link_ids.shape[0], cand.shape[0])
            merged = torch.full((hops,) + tuple(cur.shape[1:]), -1,
                                dtype=torch.int32, device=dev)
            merged[:cur.shape[0]] = cur
            merged[:cand.shape[0]] = torch.where(
                accept[None], cand[:hops], merged[:cand.shape[0]])
            nxt = torch.full((hops,) + tuple(link_ids.shape[1:]), -1,
                             dtype=torch.int32, device=dev)
            nxt[:link_ids.shape[0]] = link_ids
            nxt[:, spray] = merged
            link_ids = nxt
        extra = torch.zeros((len(flows), s), dtype=torch.float64, device=dev)
        extra.index_add_(0, res.flow_index[spray],
                         resprays * res.demand[spray][:, None])
        return dataclasses.replace(res, link_ids=link_ids,
                                   extra_exposure=self.respray_cost * extra,
                                   rounds=rounds)


def _sequential_congestion_place(comp, flows, inp, seeds, weight, order,
                                 load, link_ids, *, hash_backend, max_hops,
                                 mask=None) -> int:
    """The sequential greedy placement chain, shared by
    ``CongestionAware`` (its whole route) and ``WaveCongestionAware``
    (the round-cap fallback for still-conflicted residue).

    Routes the flows of ``order`` one at a time against — and charging —
    the ``(S, L)`` ``load`` tally, writing paths into ``link_ids`` (both
    in place; ``load`` may arrive pre-seeded with committed demand).
    With ``mask`` (an ``(N, S)`` bool of still-unplaced cells) only the
    True cells of each flow are written and charged.  On the card this
    is one launch of the placement kernel (a warp per seed); on the CPU
    its plain version.  Returns the hop-count high-water mark."""
    dev = load.device
    tabs = comp.to(dev)
    hops, fault = placement.congestion_place(
        tabs.cand, tabs.cand_n, tabs.dev_crc, tabs.is_server, tabs.link_dst,
        inp.fields, seeds, inp.src_dev, inp.dst_dev, inp.src_key,
        inp.dst_key, weight, torch.from_numpy(order).to(dev), load,
        link_ids, mask, num_keys=tabs.num_keys, c_max=tabs.c_max,
        max_hops=max_hops, murmur=hash_backend == MURMUR)
    if fault is not None:
        pos, seed_index, kind, state = fault
        flow = flows[int(order[pos])]
        if kind == 1:
            raise RuntimeError(f"flow {flow.flow_id} did not terminate in "
                               f"{max_hops} hops")
        raise RuntimeError(
            f"flow {flow.flow_id} (seed index {seed_index}) terminated at "
            f"{comp.device_names[state]}, expected {flow.dst}")
    return hops


class CongestionAware(RoutingStrategy):
    """Greedy congestion-aware selection (cf. arXiv 2506.08132).

    Flows are routed one at a time; at every hop the flow takes the
    candidate egress link carrying the least demand routed so far under
    that seed, with the flow's ECMP hash breaking exact load ties.
    Under ``demand_mode="bytes"`` flows are placed largest-first and
    each adds its demand weight, not 1, to the links it takes.  On the
    card the chain is one launch of the placement kernel (module
    docstring).
    """

    name = "congestion-aware"

    def route(self, comp, flows, seeds_u64, *, fields=FIELDS_5TUPLE,
              hash_backend=None, max_hops=16, field_matrix=None,
              demand_mode=DEMAND_UNIFORM, device=None):
        spec, inp, seeds = _walk_inputs(comp, flows, seeds_u64, fields,
                                        field_matrix, hash_backend, max_hops,
                                        device)
        dev, n, s = spec.device, len(flows), len(seeds_u64)
        flow_demand = flow_demand_weights(flows, demand_mode)
        # stable largest-first placement: uniform demand keeps the
        # original order exactly
        order = np.argsort(-flow_demand, kind="stable")
        load = torch.zeros((s, comp.num_links), dtype=torch.float64,
                           device=dev)
        link_ids = torch.full((max_hops, n, s), -1, dtype=torch.int32,
                              device=dev)
        hops = _sequential_congestion_place(
            comp, flows, inp, seeds, torch.from_numpy(flow_demand).to(dev),
            order, load, link_ids, hash_backend=spec.hash_backend,
            max_hops=max_hops)
        return VectorTraceResult(
            compiled=comp, flows=list(flows), seeds=seeds_u64,
            link_ids=link_ids[:hops].clone(), strategy=self.name,
            flow_demand=flow_demand)


def _wave_choice(cands: torch.Tensor, valid: torch.Tensor, cl: torch.Tensor,
                 h: torch.Tensor, cw: int, cool: bool = False,
                 near: bool = False) -> torch.Tensor:
    """Hash tie-break over the eligible candidate set, batched over the
    leading axes: the documented wave decision rule.

    ``cool=False``: the least-loaded candidates, ties broken by
    ``hash % n_tie`` over the tied candidates in table order (on a fresh
    fabric this *is* ECMP).  ``cool=True``: every candidate no hotter
    than the floored candidate mean (repair arrivals spread over the
    cool half); with ``near=True`` as well, candidates within one
    quantum of the minimum (polish arrivals).  ``cl`` holds loads
    quantized to integers."""
    if cool and near:
        m = torch.where(valid, cl, float("inf")).amin(-1)
        tie = valid & (cl <= m[..., None] + 1.0)
    elif cool:
        n_valid = valid.sum(-1).clamp(min=1)
        mean = torch.where(valid, cl, 0.0).sum(-1) / n_valid
        tie = valid & (cl <= torch.floor(mean)[..., None])
    else:
        tie = valid & (cl == cl.amin(-1)[..., None])
    n_tie = tie.sum(-1)
    rank = torch.where(n_tie > 1, _umod(h, n_tie.clamp(min=1)), 0)
    col = (tie.cumsum(-1) <= rank[..., None]).sum(-1)
    return cands.gather(-1, col.clamp(max=cw - 1)[..., None])[..., 0]


def _wave_walk(comp, src_dev, src_key, dst_key, fields, seeds, loads, *,
               hash_backend, max_hops, quantum, cool=False, near=False):
    """One speculative wave on the device: every (flow, seed) cell walks
    the fabric against the *frozen* ``(S, L)`` load snapshot, all cells
    at once, decisions comparing loads quantized to ``quantum``
    (``_wave_choice``).  Returns the ``(hops, N, S)`` int32 link tensor
    and the final state / done grids for the caller's arrival checks."""
    dev = fields.device
    tabs = comp.to(dev)
    na, S = len(src_dev), len(seeds)
    K, C = tabs.num_keys, tabs.c_max
    state = src_dev[:, None].expand(na, S).contiguous()
    done = torch.zeros((na, S), dtype=torch.bool, device=dev)
    flat = torch.floor(loads.reshape(-1) / quantum)
    row_off = torch.arange(S, device=dev, dtype=torch.int64) * comp.num_links
    col_idx = torch.arange(C, device=dev, dtype=torch.int64)
    out = []
    for _ in range(max_hops):
        if bool(done.all()):
            break
        key = torch.where(tabs.is_server[state], src_key[:, None],
                          dst_key[:, None])
        vk = state * K + key
        nc = tabs.cand_n[vk]                                  # (N, S)
        cw = min(int(nc.max()), C) or 1                       # live width
        cands = tabs.cand[(vk * C)[..., None] + col_idx[:cw]]  # (N, S, cw)
        valid = (col_idx[:cw] < nc[..., None]) & (cands >= 0)
        cl = torch.where(valid, flat[row_off[None, :, None]
                                     + cands.clamp(min=0)], float("inf"))
        h = hash_grid(fields, tabs.dev_crc[state] ^ seeds[None, :],
                      hash_backend)
        link = _wave_choice(cands, valid, cl, h, cw, cool, near)
        link = torch.where(done | (nc == 0), -1, link)
        out.append(link.to(torch.int32))
        nxt = torch.where(link >= 0, tabs.link_dst[link.clamp(min=0)], state)
        done |= (link < 0) | tabs.is_server[nxt]
        state = nxt
    ids = torch.stack(out) if out else torch.empty(
        (0, na, S), dtype=torch.int32, device=dev)
    return ids, state, done


def _wave_conflicts(comp, ids, src_dev, src_key, dst_key, spec_loads, *,
                    quantum, tol=1.0):
    """``(conflict, rate)`` over the (N, S) cells of a routed assignment.

    ``conflict`` flags cells whose chosen link at some hop carries at
    least ``tol`` quanta more than the mean of its candidate set under
    ``spec_loads`` (ECN-style overload marking); ``rate`` is the
    excess-proportional repair probability ``(L - mu) / (2 L)`` of the
    worst hop.  The candidate means depend only on the (device, key,
    seed) forwarding context, so they are tabulated once as a
    ``(V * K, S)`` grid and each hop of each cell costs two gathers."""
    n_hops, na, S = ids.shape
    dev = ids.device
    tabs = comp.to(dev)
    K, C = tabs.num_keys, tabs.c_max
    flatq = torch.floor(spec_loads.reshape(-1) / quantum)
    row_off = torch.arange(S, device=dev, dtype=torch.int64) * comp.num_links
    cand = tabs.cand.view(-1, C)                                 # (VK, C)
    valid_vk = ((torch.arange(C, device=dev) < tabs.cand_n[:, None])
                & (cand >= 0))
    clq = flatq[cand.clamp(min=0)[..., None] + row_off]          # (VK, C, S)
    n_valid = valid_vk.sum(-1).clamp(min=1)                      # (VK,)
    mu = (torch.where(valid_vk[..., None], clq, 0.0).sum(1)
          / n_valid[:, None])                                    # (VK, S)
    del clq
    state = src_dev[:, None].expand(na, S)
    conflict = torch.zeros((na, S), dtype=torch.bool, device=dev)
    rate = torch.zeros((na, S), dtype=torch.float64, device=dev)
    cols = torch.arange(S, device=dev, dtype=torch.int64)[None, :]
    for t in range(n_hops):
        chosen = ids[t].to(torch.int64)                          # (N, S)
        walked = chosen >= 0
        if not bool(walked.any()):
            break
        key = torch.where(tabs.is_server[state], src_key[:, None],
                          dst_key[:, None])
        own = flatq[chosen.clamp(min=0) + row_off[None, :]]
        mu_c = mu[state * K + key, cols]
        hop_conf = walked & (own >= mu_c + tol)
        conflict |= hop_conf
        hop_rate = torch.where(
            hop_conf, (own - mu_c) / (2.0 * own).clamp(min=1.0), 0.0)
        rate = torch.maximum(rate, hop_rate)
        state = torch.where(walked, tabs.link_dst[chosen.clamp(min=0)], state)
    return conflict, rate


def _mover_accept(new_ids: torch.Tensor, old_ids: torch.Tensor,
                  loads: torch.Tensor, w_flow: torch.Tensor,
                  quantum: float) -> torch.Tensor:
    """(Na, S) bool: does the re-walked path strictly improve the mover's
    hottest *differing* hop, judged self-free under the frozen snapshot?

    Only hops where old and new path disagree enter the comparison;
    loads are read with the cell's own demand removed (every old-path
    link carries it, a new-path link exactly when it is also an old-path
    link), and the comparison is quantized: an equal-quantum swap is not
    an improvement, so symmetric movers never trade places forever."""
    H = max(new_ids.shape[0], old_ids.shape[0])

    def pad(ids):
        if ids.shape[0] == H:
            return ids
        out = torch.full((H,) + tuple(ids.shape[1:]), -1, dtype=ids.dtype,
                         device=ids.device)
        out[:ids.shape[0]] = ids
        return out

    new_ids, old_ids = pad(new_ids), pad(old_ids)
    S, L = loads.shape
    flat = loads.reshape(-1)
    off = torch.arange(S, device=loads.device, dtype=torch.int64) * L

    def path_loads(ids):
        cells = torch.where(ids >= 0, ids.to(torch.int64) + off, 0)
        return torch.where(ids >= 0, flat[cells], 0.0)

    w = w_flow[None, :, None]
    neg_inf = float("-inf")
    diff = new_ids != old_ids
    old_l = path_loads(old_ids) - torch.where(old_ids >= 0, w, 0.0)
    member = ((new_ids[:, None] == old_ids[None])
              & (new_ids[:, None] >= 0)).any(1)
    new_l = path_loads(new_ids) - torch.where(member, w, 0.0)
    old_max = torch.where(diff & (old_ids >= 0), old_l, neg_inf).amax(0)
    new_max = torch.where(diff & (new_ids >= 0), new_l, neg_inf).amax(0)
    return (diff & (new_ids >= 0)).any(0) & (
        torch.floor((new_max + w_flow[:, None]) / quantum)
        < torch.floor((old_max + w_flow[:, None]) / quantum))


class WaveCongestionAware(CongestionAware):
    """Wave-parallel congestion-aware placement: speculative accept/repair
    (the predictive routing policy of arXiv 2506.08132, vectorized).

    1. **wave**: every (flow, seed) cell walks the empty fabric at once;
       with all loads zero the tie-break rule *is* ECMP, so round 0 is
       the ECMP walk, committed whole;
    2. **detect** (``_wave_conflicts``): a cell is conflicted when its
       link at some hop carries ``tolerance`` quanta more than its
       candidate-set mean; once marks fall below a quarter of the cells
       the loop latches into *polish* rounds at one quantum;
    3. **repair**: conflicted cells re-walk against the frozen loads
       (``_wave_walk``), each with its excess-proportional probability
       (times ``move_prob``) under a splitmix64 coin, and the earliest
       conflicted flow in placement order per seed always;
    4. **accept** (``_mover_accept``): only a strict quantized
       improvement of the hottest differing hop moves;
    5. **commit**: all accepted movers retract and recharge in one
       scatter pair per round;
    6. repeat until no cell is conflicted or ``max_rounds``; residue
       still conflicted at the cap goes to the sequential chain against
       the committed loads.

    Below ``min_wave_load`` flows per link, or with unequal per-flow
    weights, ``route`` delegates to ``CongestionAware`` wholesale.  The
    round loop's break and the polish latch are decisions over all seeds
    at once, so the seeds of one call are coupled: a seed list routes
    differently from its parts.
    """

    name = "wave-congestion-aware"

    def __init__(self, max_rounds: int = 16, quantum: float = 1.0,
                 move_prob: float = 1.0, tolerance: float = 2.0,
                 min_wave_load: float = 7.0):
        if max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
        if not quantum > 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        if not 0.0 < move_prob <= 1.0:
            raise ValueError(
                f"move_prob must be in (0, 1], got {move_prob}")
        if tolerance < 1:
            raise ValueError(f"tolerance must be >= 1, got {tolerance}")
        if min_wave_load < 0:
            raise ValueError(
                f"min_wave_load must be >= 0, got {min_wave_load}")
        self.max_rounds = int(max_rounds)
        self.quantum = float(quantum)
        self.move_prob = float(move_prob)
        self.tolerance = float(tolerance)
        self.min_wave_load = float(min_wave_load)

    @staticmethod
    def _check_wave(comp, flows, act, state, done, dst_dev, max_hops):
        if not bool(done.all()):
            raise RuntimeError(
                f"some flows did not terminate in {max_hops} hops")
        arrived = state == dst_dev[:, None]
        if not bool(arrived.all()):
            i, k = (~arrived).nonzero()[0].tolist()
            flow = flows[int(act[i])]
            raise RuntimeError(
                f"flow {flow.flow_id} (seed index {k}) terminated at "
                f"{comp.device_names[int(state[i, k])]}, expected {flow.dst}")

    def route(self, comp, flows, seeds_u64, *, fields=FIELDS_5TUPLE,
              hash_backend=None, max_hops=16, field_matrix=None,
              demand_mode=DEMAND_UNIFORM, device=None):
        n, s = len(flows), len(seeds_u64)
        flow_demand = flow_demand_weights(flows, demand_mode)
        # cutover: shallow waves and heterogeneous weights go to the
        # sequential chain (the reference's measured crossover)
        if (n * 1.0 / comp.num_links < self.min_wave_load
                or (n > 0 and not (flow_demand == flow_demand[0]).all())):
            return super().route(
                comp, flows, seeds_u64, fields=fields,
                hash_backend=hash_backend, max_hops=max_hops,
                field_matrix=field_matrix, demand_mode=demand_mode,
                device=device)
        spec, inp, seeds = _walk_inputs(comp, flows, seeds_u64, fields,
                                        field_matrix, hash_backend, max_hops,
                                        device)
        dev, backend, fm = spec.device, spec.hash_backend, inp.fields
        ends = (inp.src_dev, inp.dst_dev, inp.src_key, inp.dst_key)
        L, q = comp.num_links, self.quantum
        order = np.argsort(-flow_demand, kind="stable")  # same as sequential
        o_rank = np.empty(n, np.int64)
        o_rank[order] = np.arange(n, dtype=np.int64)
        o_rank = torch.from_numpy(o_rank).to(dev)
        w = torch.from_numpy(flow_demand).to(dev)
        cols = torch.arange(s, device=dev, dtype=torch.int64)
        # round 0: the whole wave walks the empty fabric, which is the
        # ECMP walk, committed as a complete assignment
        ids0 = ecmp_walk(comp, *ends, fm, seeds, hash_backend=backend,
                         max_hops=max_hops, device=dev)
        hops = ids0.shape[0]
        link_ids = torch.full((max_hops, n, s), -1, dtype=torch.int32,
                              device=dev)
        link_ids[:hops] = ids0
        load = _cell_loads(ids0, w, L)
        del ids0
        coin_id = (_splitmix64(torch.arange(n, device=dev, dtype=torch.int64))
                   [:, None] ^ seeds[None, :])
        # two-phase repair: stampede rounds mark at ``tolerance`` and
        # spread arrivals over the cool half; once marks drop below a
        # quarter of the cells, polish rounds mark at one quantum and
        # steer arrivals near-min
        polish, rounds, residue_placed = False, 0, False
        for rnd in range(self.max_rounds):
            conflict, rate = _wave_conflicts(
                comp, link_ids[:hops], ends[0], ends[2], ends[3], load,
                quantum=q, tol=1.0 if polish else self.tolerance)
            if not bool(conflict.any()):
                break
            rounds = rnd + 1
            polish = polish or int(conflict.sum()) < 0.25 * conflict.numel()
            # damped repair under a cell- and round-keyed coin ...
            coin = _splitmix64(
                coin_id ^ _u64((rnd + 1) * 0x9E3779B97F4A7C15 & _MASK64))
            coin_u = _srl(coin, 11).to(torch.float64) * 2.0 ** -53
            movers = conflict & (coin_u < self.move_prob * rate)
            # ... except the earliest conflicted flow in placement order
            # per seed, which always moves
            first = torch.where(conflict, o_rank[:, None],
                                _INT64_MAX).argmin(0)            # (S,)
            movers[first, cols] |= conflict[first, cols]
            act = movers.any(1).nonzero().squeeze(1)
            sub = tuple(e[act] for e in ends)
            w_a = w[act]
            ids_a, state, done = _wave_walk(
                comp, sub[0], sub[2], sub[3], fm[act], seeds, load,
                hash_backend=backend, max_hops=max_hops, quantum=q,
                cool=True, near=polish)
            self._check_wave(comp, flows, act, state, done, sub[1],
                             max_hops)
            old = link_ids[:hops][:, act]
            accept = movers[act] & _mover_accept(ids_a, old, load, w_a, q)
            if not bool(accept.any()):
                continue
            t_end = max(hops, ids_a.shape[0])
            pad_new = torch.full((t_end,) + tuple(ids_a.shape[1:]), -1,
                                 dtype=torch.int32, device=dev)
            pad_new[:ids_a.shape[0]] = ids_a
            pad_old = torch.full_like(pad_new, -1)
            pad_old[:hops] = old
            sel_new = torch.where(accept[None], pad_new, -1)
            sel_old = torch.where(accept[None], pad_old, -1)
            # atomic per-round commit: every accepted mover's old demand
            # is retracted and its new demand charged in one scatter pair
            load += (_cell_loads(sel_new, w_a, L)
                     - _cell_loads(sel_old, w_a, L))
            link_ids[:t_end, act] = torch.where(
                accept[None], pad_new, link_ids[:t_end, act])
            hops = t_end
        else:
            # round cap without fixpoint: retract whatever is still
            # conflicted and place it with the sequential chain
            residue, _ = _wave_conflicts(
                comp, link_ids[:hops], ends[0], ends[2], ends[3], load,
                quantum=q, tol=self.tolerance)
            if bool(residue.any()):
                residue_placed = True
                sel = torch.where(residue[None], link_ids[:hops], -1)
                load -= _cell_loads(sel, w, L)
                link_ids[:hops] = torch.where(residue[None], -1,
                                              link_ids[:hops])
                hops = max(hops, _sequential_congestion_place(
                    comp, flows, inp, seeds, w, order, load, link_ids,
                    hash_backend=backend, max_hops=max_hops, mask=residue))
        return VectorTraceResult(
            compiled=comp, flows=list(flows), seeds=seeds_u64,
            link_ids=link_ids[:hops], strategy=self.name,
            flow_demand=flow_demand, rounds=rounds,
            residue_placed=residue_placed)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], RoutingStrategy]] = {
    "ecmp": EcmpStrategy,
    "prime-spray": PrimeSpraying,
    "prime-spray-elephant": lambda: PrimeSpraying(
        min_bytes=ELEPHANT_MIN_BYTES, volume_k=True),
    "congestion-aware": CongestionAware,
    "wave-congestion-aware": WaveCongestionAware,
    "adaptive-spray": AdaptiveSpraying,
    "adaptive-spray-elephant": lambda: AdaptiveSpraying(
        min_bytes=ELEPHANT_MIN_BYTES, volume_k=True),
}


def register_strategy(name: str,
                      factory: Callable[[], RoutingStrategy],
                      *, replace: bool = False) -> None:
    """Register a strategy factory under ``name`` for the
    ``strategy="..."`` string form.  A duplicate name raises unless
    ``replace=True``: a silent overwrite of e.g. ``"ecmp"`` would swap
    the baseline out from under every caller."""
    if not replace and name in _REGISTRY:
        raise ValueError(
            f"routing strategy {name!r} is already registered "
            f"(registered: {available_strategies()}); pass replace=True "
            f"to overwrite it")
    _REGISTRY[name] = factory


def available_strategies() -> list[str]:
    return sorted(_REGISTRY)


def resolve_strategy(strategy: RoutingStrategy | str) -> RoutingStrategy:
    """A ``RoutingStrategy`` instance passes through; a string constructs
    the registered default configuration of that family."""
    if isinstance(strategy, RoutingStrategy):
        return strategy
    if isinstance(strategy, str):
        try:
            return _REGISTRY[strategy]()
        except KeyError:
            raise ValueError(
                f"unknown routing strategy {strategy!r}; "
                f"registered: {available_strategies()}") from None
    raise TypeError(
        f"strategy must be a RoutingStrategy or registered name, "
        f"got {type(strategy).__name__}")
