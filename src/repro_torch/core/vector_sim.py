"""Vectorized fabric path simulation on the card: all flows x all seeds.

The PyTorch port of ``repro.core.vector_sim`` (the numpy engine, which
stays the differential reference).  The forwarding process runs as
whole-tensor operations on a ``CompiledFabric``'s device tables:

* state is an ``(N flows, S seeds)`` tensor of current-device ids;
* each hop gathers the candidate set of every (flow, seed), hashes the
  flow's fields under the per-switch device seed
  ``dev_crc[state] ^ seed``, and picks ``hash % n_candidates``;
* the walk stops when every (flow, seed) lands on a server.

Hash backends: ``"exact"`` is the tracer-identical splitmix64 chain over
CRC32 fields, here on int64 tensors (see ``_mix64``); ``"murmur"`` is the
murmur3 grid of ``kernels/flowhash`` — the CUDA kernel on the card, its
plain version on the CPU.  ``hash_backend=None`` means murmur on the
card and exact on the CPU, the JAX package's accelerator/host policy.

Unsigned 64-bit arithmetic lives in int64: multiplies wrap modulo 2**64
exactly as uint64 does, logical right shifts mask off the sign-extended
bits, seeds at or above 2**63 cross in as ``np.uint64 -> view(int64)``,
and the walk's ``hash % n`` is an unsigned modulo over 32-bit halves.

Plain ECMP walks the seeds in chunks sized from the card's free memory
and keeps walk -> counts -> FIM on the device.  Every other routing
strategy (``core/strategies.py``) routes the whole seed list in one
pass: some couple their seeds through loop-wide decisions, so a chunk
would route differently.  Results stay device tensors until the caller
asks for them (``summary()``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.flowhash.ops import murmur_hash_grid
from .compile_fabric import CompiledFabric, compile_fabric
from .contracts import check_spec, check_trace_result, contracts_enabled
from .ecmp import (
    FIELDS_5TUPLE, FIELDS_IP_PAIR, FIELDS_VXLAN, HASH_INIT,
    flow_fields_matrix,
)
from .fabric import Fabric, nic_ip
from .flows import Flow, WorkloadDescription, synthesize_flows
from .reordering import resolve_transport

EXACT = "exact"    # splitmix64 over CRC32 fields, tracer-identical
MURMUR = "murmur"  # kernels/flowhash murmur3 (the CUDA kernel on the card)

DEMAND_UNIFORM = "uniform"  # every flow weighs 1
DEMAND_BYTES = "bytes"      # flows weigh their wire bytes (mean-normalized)

# Front ends default every per-simulation kwarg to this so "not passed"
# is distinguishable from "passed its default": mixing an explicit kwarg
# with ``spec=`` raises instead of silently picking a winner.
_UNSET = object()

_KNOWN_FIELDS = (FIELDS_5TUPLE, FIELDS_VXLAN, FIELDS_IP_PAIR)

TIMING_STATIC = "static"  # exogenous step durations (TimelineStep.duration)
TIMING_EVENT = "event"    # durations derived from routed goodput: a step
#                           ends when its slowest flow's bytes finish, and
#                           flows depart mid-step (vector_throughput.
#                           departure_fill); see core/timeline.py

#: Upper estimates of device bytes held per (flow, seed) cell while a
#: seed chunk is walked, and while it is walked and then filled; the
#: chunk is sized so that half the free memory covers them.  Measured
#: peaks on an H100 (chip_smoke.py, 4-hop multipod walk, PERF.md): 102
#: bytes per cell for walk -> counts, 184 for walk -> fill.
WALK_BYTES_PER_CELL = 160
FILL_BYTES_PER_CELL = 256
#: what a chunk may hold on the host, where free memory is not probed
_CPU_CHUNK_BYTES = 1 << 30


def resolve_flows(
    comp: CompiledFabric,
    workload: WorkloadDescription | Sequence[Flow],
) -> list[Flow]:
    """A ``WorkloadDescription`` is synthesized into flows (round-robin
    over the compiled fabric's *recorded* NIC indices); an explicit flow
    sequence passes through."""
    if isinstance(workload, WorkloadDescription):
        idx = comp.nic_indices
        return synthesize_flows(
            workload, nic_ip=lambda srv, k: nic_ip(srv, idx[k]),
            nics_per_server=len(idx))
    return list(workload)


def resolve_hash_backend(hash_backend: str | None,
                         device: torch.device) -> str:
    """``None`` means the device's natural backend: murmur (the CUDA
    kernel) on the card, the exact tracer-identical splitmix64 on the
    CPU.  An explicit backend always wins; an unknown one fails here."""
    if hash_backend is not None:
        if hash_backend not in (EXACT, MURMUR):
            raise ValueError(
                f"unknown hash_backend {hash_backend!r}; "
                f"have {(EXACT, MURMUR)}")
        return hash_backend
    return MURMUR if torch.device(device).type == "cuda" else EXACT


def flow_demand_weights(flows: Sequence[Flow], demand_mode: str) -> np.ndarray:
    """(N,) strictly positive per-flow demand weights.

    ``"uniform"`` is all-ones.  ``"bytes"`` weighs each flow by
    ``Flow.bytes``, normalized to mean 1; all-equal bytes (including all
    zero) return exact ones, and zero-byte flows inside a heterogeneous
    workload are floored at 1 byte.
    """
    n = len(flows)
    if demand_mode == DEMAND_UNIFORM:
        return np.ones(n)
    if demand_mode != DEMAND_BYTES:
        raise ValueError(
            f"unknown demand_mode {demand_mode!r}; "
            f"expected {DEMAND_UNIFORM!r} or {DEMAND_BYTES!r}")
    b = np.array([f.bytes for f in flows], np.float64)
    if n == 0 or (b == b[0]).all():
        return np.ones(n)
    b = np.maximum(b, 1.0)
    return b / b.mean()


# ---------------------------------------------------------------------------
# SimSpec: the one validated description of *how* to simulate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Every knob that selects *how* a simulation runs, in one place.

    Front ends accept ``spec=SimSpec(...)`` *or* the per-simulation
    kwargs (which build a SimSpec internally); passing both raises.

    * ``strategy`` — ``None`` (per-flow ECMP), a registered name
      (``"wave-congestion-aware"``) or a ``RoutingStrategy`` instance;
      ``resolve()`` makes a name an instance;
    * ``demand_mode`` — ``"uniform"`` or ``"bytes"``;
    * ``device`` — ``None`` (the card, raising without one) or an
      explicit device such as ``"cpu"``; ``resolve()`` makes it a
      ``torch.device``;
    * ``hash_backend`` — ``"exact"``, ``"murmur"`` or ``None`` for the
      device's natural backend (``resolve_hash_backend``);
    * ``transport`` — ``None``/name/``TransportProfile``, read by the
      throughput front end;
    * ``fields`` — the hash-field mode (``"5tuple"``/``"vxlan"``/
      ``"ip-pair"``);
    * ``max_hops`` — walk hop budget;
    * ``timing`` — how ``simulate_timeline`` prices the time axis:
      ``"static"`` (exogenous ``TimelineStep.duration`` weights) or
      ``"event"`` (step durations derived from the routed max-min
      goodput, flows departing as their bytes finish; core/timeline.py).
      Snapshot front ends ignore it.

    ``resolve()`` is idempotent.
    """

    strategy: object = None
    demand_mode: str = DEMAND_UNIFORM
    device: object = None
    hash_backend: str | None = None
    transport: object = None
    fields: str = FIELDS_5TUPLE
    max_hops: int = 16
    timing: str = TIMING_STATIC

    def resolve(self) -> "SimSpec":
        if self.timing not in (TIMING_STATIC, TIMING_EVENT):
            raise ValueError(
                f"unknown timing {self.timing!r}; "
                f"expected {TIMING_STATIC!r} or {TIMING_EVENT!r}")
        if self.demand_mode not in (DEMAND_UNIFORM, DEMAND_BYTES):
            raise ValueError(
                f"unknown demand_mode {self.demand_mode!r}; "
                f"expected {DEMAND_UNIFORM!r} or {DEMAND_BYTES!r}")
        if self.fields not in _KNOWN_FIELDS:
            raise ValueError(
                f"unknown fields mode {self.fields!r}; "
                f"have {_KNOWN_FIELDS}")
        if int(self.max_hops) < 1:
            raise ValueError(f"max_hops must be >= 1, got {self.max_hops}")
        strategy = self.strategy
        if strategy is not None:
            from .strategies import resolve_strategy
            strategy = resolve_strategy(strategy)
        transport = (None if self.transport is None
                     else resolve_transport(self.transport))
        device = resolve_device(self.device)
        return dataclasses.replace(
            self, strategy=strategy, transport=transport, device=device,
            hash_backend=resolve_hash_backend(self.hash_backend, device),
            max_hops=int(self.max_hops))


def resolve_spec(spec: SimSpec | None, kwargs: dict) -> SimSpec:
    """The resolved ``SimSpec`` from ``spec=`` OR the kwargs (values
    still ``_UNSET`` are dropped, so dataclass defaults apply)."""
    passed = {k: v for k, v in kwargs.items() if v is not _UNSET}
    if spec is not None:
        if passed:
            raise ValueError(
                "pass either spec= or the per-simulation kwargs, not both "
                f"(got spec= together with {sorted(passed)})")
        if not isinstance(spec, SimSpec):
            raise TypeError(
                f"spec must be a SimSpec, got {type(spec).__name__}")
        s = spec.resolve()
    else:
        s = SimSpec(**passed).resolve()
    if contracts_enabled():
        check_spec(s)
    return s


# ---------------------------------------------------------------------------
# Hash grids on int64 tensors
# ---------------------------------------------------------------------------

def _u64(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_M1 = _u64(0xBF58476D1CE4E5B9)
_M2 = _u64(0x94D049BB133111EB)
_INIT = _u64(HASH_INIT)
_LO32 = 0xFFFFFFFF


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a uint64 held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer; int64 multiplies wrap like uint64 ones."""
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def ecmp_hash_grid(fields: torch.Tensor, dev_seed: torch.Tensor) -> torch.Tensor:
    """The exact ``ecmp_hash`` for every cell: fields (N, F) int64 (the
    uint64 bits), dev_seed (N, S) int64 -> (N, S) int64 holding the
    uint64 hash bits."""
    h = _mix64(dev_seed ^ _INIT)
    for f in range(fields.shape[1]):
        h = _mix64(h ^ fields[:, f : f + 1])
    return h


def hash_grid(fields: torch.Tensor, dev_seed: torch.Tensor,
              hash_backend: str) -> torch.Tensor:
    """Per-(flow, seed) hash grid under the selected backend."""
    if hash_backend == EXACT:
        return ecmp_hash_grid(fields, dev_seed)
    if hash_backend == MURMUR:
        return murmur_hash_grid(fields, dev_seed)
    raise ValueError(f"unknown hash backend: {hash_backend}")


def _umod(h: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``h % n`` for uint64 bits ``h`` held in int64 and 1 <= n < 2**31:
    ``torch.remainder`` would read h >= 2**63 as negative, so reduce the
    32-bit halves, ``(hi * 2**32 + lo) % n``, instead."""
    hi = _srl(h, 32)
    lo = h & _LO32
    pow32 = torch.remainder(torch.full_like(n, 1 << 32), n)
    return (hi % n * pow32 + lo % n) % n


def normalize_seeds(seeds: Sequence[int] | np.ndarray) -> np.ndarray:
    """(S,) uint64 seed array, masked to 64 bit like the Python tracer."""
    return np.array(
        [int(s) & 0xFFFFFFFFFFFFFFFF for s in np.asarray(seeds).tolist()],
        np.uint64)


def _as_int64(a, device: torch.device) -> torch.Tensor:
    """Host arrays (uint64 viewed bit for bit) or tensors -> int64 on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VectorTraceResult:
    """Paths for N flows under S seeds, as a dense device link-id tensor.

    Multi-path strategies (spraying) emit more tensor columns than there
    are flows: each column is a *flowlet* — ``flow_index[j]`` names its
    parent flow (row into ``flows``) and ``demand[j]`` the fraction of the
    parent's demand it carries (flowlet demands sum to 1 per flow).
    Single-path results leave the defaults (``flow_index == arange(N)``,
    ``demand == 1``).  ``flow_demand`` carries the per-flow demand weight
    (``demand_mode="bytes"`` derives it from ``Flow.bytes`` normalized to
    mean 1); a column's weight in the link loads and the max-min fill is
    ``flow_demand[flow_index[j]] * demand[j]`` (``column_weights``).

    ``extra_exposure`` is an optional (N, S) reordering exposure a
    strategy charges on top of what the flowlet tensors imply (adaptive
    re-spray bills its accepted mid-flow path changes there).  Arrays
    given as numpy become tensors on ``link_ids``' device.  ``rounds`` and
    ``residue_placed`` report what an iterative strategy did: adaptive
    re-spray's feedback rounds, the wave's repair rounds and whether its
    residue at the round cap went to the sequential chain.
    """

    compiled: CompiledFabric
    flows: list[Flow]
    seeds: np.ndarray            # (S,) uint64 (as given, masked to 64 bit)
    link_ids: torch.Tensor       # (H, Nf, S) int32 link ids, -1 past arrival
    flow_index: torch.Tensor | None = None   # (Nf,) int64 parent-flow row
    demand: torch.Tensor | None = None       # (Nf,) float64 demand fraction
    strategy: str = "ecmp"
    flow_demand: torch.Tensor | None = None  # (N,) float64 per-flow weight
    extra_exposure: torch.Tensor | None = None  # (N, S) float64
    rounds: int = 0              # feedback / repair rounds the strategy ran
    residue_placed: bool = False  # the wave's round-cap residue was chained

    def __post_init__(self):
        dev, nf = self.link_ids.device, self.link_ids.shape[1]

        def on_dev(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        f64 = torch.float64
        self.flow_index = on_dev(np.arange(nf) if self.flow_index is None
                                 else self.flow_index, torch.int64)
        self.demand = on_dev(np.ones(nf) if self.demand is None
                             else self.demand, f64)
        self.flow_demand = on_dev(np.ones(len(self.flows))
                                  if self.flow_demand is None
                                  else self.flow_demand, f64)
        if self.extra_exposure is not None:
            self.extra_exposure = on_dev(self.extra_exposure, f64)

    @property
    def num_flows(self) -> int:
        return len(self.flows)

    @property
    def num_flowlets(self) -> int:
        return self.link_ids.shape[1]

    @property
    def num_seeds(self) -> int:
        return len(self.seeds)

    @property
    def is_multipath(self) -> bool:
        return self.num_flowlets != self.num_flows

    def hop_counts(self) -> torch.Tensor:
        """(Nf, S) links crossed per tensor column per seed — the
        path-length grid the reordering model's skew term reads."""
        return (self.link_ids >= 0).sum(0)

    def paths_for_seed(self, seed_index: int) -> dict[int, list]:
        """Materialize one seed's paths in ``FlowTracer`` format (each a
        list of ``Link``), for differential testing and drop-in use with
        the dict-based tools (``fim``, ``per_pair_throughput``,
        ``analyze_paths``).  Single-path results only; multi-path callers
        want ``flowlet_paths_for_seed``.  The seed's (H, N) slice is read
        to the host in one copy."""
        if self.is_multipath:
            raise ValueError(
                f"{self.strategy!r} result has {self.num_flowlets} flowlets "
                f"for {self.num_flows} flows; use flowlet_paths_for_seed")
        links = self.compiled.links
        cols = self.link_ids[:, :, seed_index].T.tolist()
        return {flow.flow_id: [links[i] for i in col if i >= 0]
                for flow, col in zip(self.flows, cols)}

    def flowlet_paths_for_seed(self, seed_index: int) -> dict[int, list]:
        """One seed's paths per flow id, as a *list* of flowlet paths
        (each a list of ``Link``)."""
        links = self.compiled.links
        out: dict[int, list] = {f.flow_id: [] for f in self.flows}
        ids = self.link_ids[:, :, seed_index].cpu().numpy()
        fi = self.flow_index.cpu().numpy()
        for j in range(self.num_flowlets):
            out[self.flows[int(fi[j])].flow_id].append(
                [links[i] for i in ids[:, j] if i >= 0])
        return out

    def column_weights(self) -> torch.Tensor:
        """(Nf,) effective demand per tensor column: the parent flow's
        ``flow_demand`` times the column's flowlet fraction.  Uniform
        flow demand short-circuits to ``demand`` itself."""
        if bool((self.flow_demand == 1.0).all()):
            return self.demand
        return self.flow_demand[self.flow_index] * self.demand

    def link_flow_counts(self) -> torch.Tensor:
        """(S, L) flow load per link per seed (int64 under unit demand,
        float64 demand sums otherwise)."""
        return link_counts(self.link_ids, _weights_or_none(
            self.column_weights()), self.compiled.num_links)


def segment_reduce(values: torch.Tensor, fi: torch.Tensor, n: int,
                   reduce: str, fill: float) -> torch.Tensor:
    """Per-parent ``reduce`` (``"sum"``, ``"amin"`` or ``"amax"``) over
    the column axis of an ``(Nf, S)`` tensor, grouping columns by ``fi``
    (their parent-flow rows) into ``(n, S)``.  Parent-sorted contiguous
    ``fi`` in which every parent has a column — the flowlet layout every
    built-in strategy emits — takes ``torch.segment_reduce`` over the
    run lengths; anything else a scatter, where a parent without columns
    reads ``fill``.  On the CPU both sum in column order; the
    reference's ``reduceat`` sums long segments pairwise, so per-parent
    sums agree with it to rounding, minima and maxima exactly."""
    S = values.shape[1]
    if fi.numel() and bool((fi[1:] >= fi[:-1]).all()):
        lengths = torch.bincount(fi, minlength=n)
        if lengths.numel() == n and bool((lengths > 0).all()):
            return torch.segment_reduce(
                values, {"sum": "sum", "amin": "min", "amax": "max"}[reduce],
                lengths=lengths, axis=0)
    out = torch.full((n, S), fill, dtype=values.dtype, device=values.device)
    if reduce == "sum":
        return out.index_add_(0, fi, values)
    return out.scatter_reduce_(0, fi[:, None].expand(-1, S), values, reduce,
                               include_self=False)


def _weights_or_none(w: torch.Tensor) -> torch.Tensor | None:
    return None if bool((w == 1.0).all()) else w


def link_counts(link_ids: torch.Tensor, weights: torch.Tensor | None,
                num_links: int) -> torch.Tensor:
    """(S, L) per-link load of an (H, N, S) link-id tensor, one bincount
    per hop (no (H*N*S,) index tensor is ever built).  ``weights=None``
    counts flows exactly in int64; a (N,) weight vector sums demand in
    float64 — on the card with atomics, so in run-dependent order."""
    H, N, S = link_ids.shape
    L = num_links
    sentinel = S * L               # "no link at this hop" bin, dropped
    off = torch.arange(S, device=link_ids.device, dtype=torch.int64) * L
    w = None if weights is None else weights[:, None].expand(N, S).reshape(-1)
    total = None
    for h in range(H):
        ids = link_ids[h]
        flat = torch.where(ids >= 0, ids.to(torch.int64) + off,
                           sentinel).reshape(-1)
        c = torch.bincount(flat, weights=w, minlength=sentinel + 1)
        total = c if total is None else total.add_(c)
    if total is None:
        total = torch.zeros(sentinel + 1, device=link_ids.device,
                            dtype=torch.int64 if w is None else torch.float64)
    return total[:sentinel].reshape(S, L)


def ecmp_walk(
    comp: CompiledFabric,
    src_dev,
    dst_dev,
    src_key,
    dst_key,
    field_mat,
    seeds_u64,
    *,
    hash_backend: str | None = None,
    max_hops: int = 16,
    cell_salt=None,
    describe=lambda n: f"column {n}",
    device=None,
) -> torch.Tensor:
    """The raw hop-by-hop hashed walk over explicit endpoint/field arrays.

    Candidates come from the compiled ``Forwarder`` tables;
    ``hash % n_candidates`` when the set has more than one member, the
    only candidate otherwise.  Returns the ``(hops, N, S)`` int32 link-id
    tensor on ``device``.  Inputs may be host arrays (uint64 seeds and
    fields are taken bit for bit) or tensors.

    ``cell_salt`` optionally XORs an ``(N, S)`` 64-bit salt into every
    hop's device seed; a zero cell walks exactly as without salt.
    """
    dev = resolve_device(device)
    hash_backend = resolve_hash_backend(hash_backend, dev)
    tabs = comp.to(dev)
    src_dev, dst_dev, src_key, dst_key, fields, seeds = (
        _as_int64(a, dev) for a in (src_dev, dst_dev, src_key, dst_key,
                                    field_mat, seeds_u64))
    fields = fields.reshape(len(src_dev), -1).contiguous()
    salt = None if cell_salt is None else _as_int64(cell_salt, dev)
    N, S = len(src_dev), len(seeds)
    K, C = tabs.num_keys, tabs.c_max

    state = src_dev[:, None].expand(N, S).contiguous()
    done = torch.zeros((N, S), dtype=torch.bool, device=dev)
    hops: list[torch.Tensor] = []
    for _ in range(max_hops):
        if bool(done.all()):
            break
        # src-keyed on the source host (hop 0), dst-keyed at every switch
        key = torch.where(tabs.is_server[state], src_key[:, None],
                          dst_key[:, None])
        vk = state * K + key
        del key
        n = tabs.cand_n[vk]                          # (N, S)
        dev_seed = tabs.dev_crc[state] ^ seeds[None, :]
        if salt is not None:
            dev_seed = dev_seed ^ salt
        h = hash_grid(fields, dev_seed, hash_backend)
        del dev_seed
        choice = torch.where(n > 1, _umod(h, n.clamp(min=1)), 0)
        del h
        link = tabs.cand[vk * C + choice]
        del vk, choice
        link = torch.where(done | (n == 0), -1, link)
        del n
        hops.append(link.to(torch.int32))
        nxt = torch.where(link >= 0, tabs.link_dst[link.clamp(min=0)], state)
        done |= (link < 0) | tabs.is_server[nxt]
        state = nxt
        del link

    if not bool(done.all()):
        raise RuntimeError(f"some flows did not terminate in {max_hops} hops")
    arrived = state == dst_dev[:, None]
    if not bool(arrived.all()):
        bad = (~arrived).nonzero()[0].tolist()
        raise RuntimeError(
            f"{describe(bad[0])} (seed index {bad[1]}) terminated "
            f"at {comp.device_names[int(state[bad[0], bad[1]])]}")
    return torch.stack(hops) if hops else torch.empty(
        (0, N, S), dtype=torch.int32, device=dev)


@dataclasses.dataclass(frozen=True)
class _WalkInputs:
    """A flow table's per-flow walk inputs, on the device, built once
    per front-end call and reused by every seed chunk."""

    flows: list[Flow]
    src_dev: torch.Tensor
    dst_dev: torch.Tensor
    src_key: torch.Tensor
    dst_key: torch.Tensor
    fields: torch.Tensor
    flow_demand: torch.Tensor

    def walk(self, comp: CompiledFabric, seeds: torch.Tensor,
             s: SimSpec) -> torch.Tensor:
        return ecmp_walk(
            comp, self.src_dev, self.dst_dev, self.src_key, self.dst_key,
            self.fields, seeds, hash_backend=s.hash_backend,
            max_hops=s.max_hops,
            describe=lambda n: f"flow {self.flows[n].flow_id}",
            device=s.device)


def _walk_inputs(comp: CompiledFabric, flows: list[Flow], s: SimSpec,
                 field_matrix) -> _WalkInputs:
    if len(flows) == 0:
        raise ValueError("simulate_paths needs at least one flow")
    dev = s.device
    field_mat = (field_matrix if field_matrix is not None
                 else flow_fields_matrix(flows, s.fields))  # (N, F) uint64
    ends = comp.flow_endpoint_ids(flows)
    return _WalkInputs(
        flows, *(_as_int64(a, dev) for a in ends),
        fields=_as_int64(field_mat, dev).reshape(len(flows), -1).contiguous(),
        flow_demand=torch.from_numpy(
            flow_demand_weights(flows, s.demand_mode)).to(dev))


def seed_chunk_size(n_flows: int, n_seeds: int, bytes_per_cell: int,
                    device: torch.device) -> int:
    """Seeds per device pass: half the memory PyTorch can still use
    (free on the card plus what its allocator caches unused), over the
    per-cell estimate.  On the CPU a fixed 1 GiB budget."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = (free + torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device)) // 2
    else:
        budget = _CPU_CHUNK_BYTES
    per_seed = max(1, n_flows) * bytes_per_cell
    return int(max(1, min(n_seeds, budget // per_seed)))


def _seed_chunks(n_seeds: int, chunk: int):
    for s0 in range(0, n_seeds, chunk):
        yield s0, min(s0 + chunk, n_seeds)


def simulate_paths(
    fabric: Fabric | CompiledFabric,
    flows: Sequence[Flow],
    seeds: Sequence[int] | np.ndarray,
    *,
    spec: SimSpec | None = None,
    fields=_UNSET,
    hash_backend=_UNSET,
    max_hops=_UNSET,
    field_matrix: np.ndarray | None = None,
    strategy=_UNSET,
    demand_mode=_UNSET,
    device=_UNSET,
) -> VectorTraceResult:
    """Walk every flow through the fabric under every seed, on the device.

    How to simulate is a ``SimSpec`` — ``spec=`` or the kwargs, not
    both.  Per-flow ECMP under ``hash_backend="exact"`` is bit-identical
    to the JAX package's tracer and numpy engine; ``strategy`` (a name or
    a ``RoutingStrategy``) routes through that strategy instead, and the
    result may carry flowlet columns (``VectorTraceResult``).
    ``field_matrix`` optionally supplies precomputed
    ``flow_fields_matrix`` output.  The whole (H, Nf, S) tensor is
    materialized at once; the Monte-Carlo front ends walk plain ECMP in
    seed chunks instead.
    """
    s = resolve_spec(spec, dict(
        fields=fields, hash_backend=hash_backend, max_hops=max_hops,
        strategy=strategy, demand_mode=demand_mode, device=device))
    comp = fabric if isinstance(fabric, CompiledFabric) else compile_fabric(fabric)
    flows = list(flows)
    seeds_u64 = normalize_seeds(seeds)
    if not _is_plain_ecmp(s.strategy):
        if len(flows) == 0:
            raise ValueError("simulate_paths needs at least one flow")
        res = s.strategy.route(
            comp, flows, seeds_u64, fields=s.fields,
            hash_backend=s.hash_backend, max_hops=s.max_hops,
            field_matrix=field_matrix, demand_mode=s.demand_mode,
            device=s.device)
    else:
        inp = _walk_inputs(comp, flows, s, field_matrix)
        link_ids = inp.walk(comp, _as_int64(seeds_u64, s.device), s)
        res = VectorTraceResult(
            compiled=comp, flows=flows, seeds=seeds_u64, link_ids=link_ids,
            flow_demand=inp.flow_demand)
    if contracts_enabled():
        check_trace_result(res)
    return res


def _is_plain_ecmp(strategy) -> bool:
    """True when ``strategy`` asks for the default per-flow ECMP walk,
    which the front ends run seed-chunked.  Configured or custom
    strategies (subclasses of ``EcmpStrategy`` too) route through their
    own ``route``."""
    if strategy is None:
        return True
    from .strategies import EcmpStrategy
    return type(strategy) is EcmpStrategy


# ---------------------------------------------------------------------------
# Vectorized link loads / FIM
# ---------------------------------------------------------------------------


def fim_from_counts(
    counts: torch.Tensor,
    comp: CompiledFabric,
    *,
    layers: Sequence[str] | None = None,
    only_used_leaves: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Aggregate and per-layer FIM per seed from an (S, L) count tensor.

    Per layer, ideal = total/links and FIM is the MAPE over links;
    layers with zero traffic are dropped; the aggregate weights each
    layer by its link count.  With ``only_used_leaves`` links are
    restricted per seed to those whose both endpoints carried traffic
    under that seed.
    """
    S = counts.shape[0]
    dev = counts.device
    tabs = comp.to(dev)
    # an empty list also means "all layers"
    layer_list = list(layers) if layers else comp.layer_names
    if only_used_leaves:
        present = (counts > 0).to(torch.int64)      # (S, L)
        used = torch.zeros((S, comp.num_devices), dtype=torch.int64,
                           device=dev)
        for ends in (tabs.link_src, tabs.link_dst):
            used.scatter_reduce_(1, ends[None, :].expand(S, -1), present,
                                 "amax")
        used = used.bool()

    num = torch.zeros(S, dtype=torch.float64, device=dev)
    den = torch.zeros(S, dtype=torch.float64, device=dev)
    per_layer: dict[str, torch.Tensor] = {}
    for layer in layer_list:
        if layer not in comp.layer_names:
            continue
        lid = comp.layer_names.index(layer)
        sel = (tabs.link_layer == lid).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        c = counts[:, sel].to(torch.float64)        # (S, Ll)
        if only_used_leaves:
            mask = (used[:, tabs.link_src[sel]]
                    & used[:, tabs.link_dst[sel]]).to(torch.float64)
        else:
            mask = torch.ones_like(c)
        n_links = mask.sum(1)                       # (S,)
        total = (c * mask).sum(1)
        live = (total > 0) & (n_links > 0)
        if not bool(live.any()):
            continue
        nl1 = n_links.clamp(min=1.0)
        ideal = torch.where(live, total / nl1, 1.0)
        mape = (100.0 / nl1
                * ((c - ideal[:, None]).abs() / ideal[:, None] * mask).sum(1))
        mape = torch.where(live, mape, 0.0)
        per_layer[layer] = mape
        num += torch.where(live, mape * n_links, 0.0)
        den += torch.where(live, n_links, 0.0)
    agg = torch.where(den > 0, num / den.clamp(min=1.0), 0.0)
    return agg, per_layer


def fim_vector(
    result: VectorTraceResult,
    *,
    layers: Sequence[str] | None = None,
    only_used_leaves: bool = False,
) -> torch.Tensor:
    """(S,) aggregate FIM per seed of a routed result."""
    agg, _ = fim_from_counts(result.link_flow_counts(), result.compiled,
                             layers=layers, only_used_leaves=only_used_leaves)
    return agg


def _stats(v: np.ndarray) -> dict[str, float]:
    return {
        "mean": float(v.mean()),
        "std": float(v.std()),
        "min": float(v.min()),
        "p50": float(np.percentile(v, 50)),
        "p95": float(np.percentile(v, 95)),
        "max": float(v.max()),
    }


@dataclasses.dataclass
class MonteCarloFim:
    """FIM distributions over a hash-seed sweep (device tensors)."""

    seeds: np.ndarray                       # (S,)
    aggregate: torch.Tensor                 # (S,) FIM per seed
    per_layer: dict[str, torch.Tensor]      # layer -> (S,) FIM per seed
    seed_chunk: int = 0                     # seeds per device pass

    def summary(self) -> dict[str, dict[str, float]]:
        rows = {"aggregate": self.aggregate, **self.per_layer}
        return {name: _stats(v.cpu().numpy()) for name, v in rows.items()}


def monte_carlo_fim(
    fabric: Fabric | CompiledFabric,
    workload: WorkloadDescription | Sequence[Flow],
    seeds: Sequence[int] | np.ndarray,
    *,
    spec: SimSpec | None = None,
    fields=_UNSET,
    hash_backend=_UNSET,
    layers: Sequence[str] | None = None,
    only_used_leaves: bool = False,
    strategy=_UNSET,
    demand_mode=_UNSET,
    device=_UNSET,
    max_hops=_UNSET,
    field_matrix: np.ndarray | None = None,
) -> MonteCarloFim:
    """FIM distribution of a routing strategy across a hash-seed sweep.

    ``workload`` may be a ``WorkloadDescription`` or an explicit flow
    list; how to simulate is a ``SimSpec`` (``spec=`` or the kwargs).
    ``layers`` / ``only_used_leaves`` describe what to measure.

    Plain ECMP walks the seeds in chunks sized from free device memory
    (``seed_chunk_size``); each chunk's walk reduces to its (chunk, L)
    link counts on the device and only the counts are kept, so the
    sweep's memory is bounded by one chunk.  The chunking never changes
    results.  Every other strategy routes the whole seed list in one
    pass (``seed_chunk`` is then the seed count).
    """
    s = resolve_spec(spec, dict(
        fields=fields, hash_backend=hash_backend, strategy=strategy,
        demand_mode=demand_mode, device=device, max_hops=max_hops))
    comp = fabric if isinstance(fabric, CompiledFabric) else compile_fabric(fabric)
    flows = resolve_flows(comp, workload)
    seeds_u64 = normalize_seeds(seeds)
    S, L = len(seeds_u64), comp.num_links
    if not _is_plain_ecmp(s.strategy):
        res = simulate_paths(comp, flows, seeds_u64, spec=s,
                             field_matrix=field_matrix)
        counts, chunk = res.link_flow_counts(), S
    else:
        inp = _walk_inputs(comp, flows, s, field_matrix)
        weights = _weights_or_none(inp.flow_demand)
        seeds_t = _as_int64(seeds_u64, s.device)
        chunk = seed_chunk_size(len(flows), S, WALK_BYTES_PER_CELL, s.device)
        counts = torch.empty(
            (S, L), device=s.device,
            dtype=torch.int64 if weights is None else torch.float64)
        for s0, s1 in _seed_chunks(S, chunk):
            ids = inp.walk(comp, seeds_t[s0:s1], s)
            counts[s0:s1] = link_counts(ids, weights, L)
            del ids
    agg, per_layer = fim_from_counts(
        counts, comp, layers=layers, only_used_leaves=only_used_leaves)
    return MonteCarloFim(seeds=seeds_u64, aggregate=agg, per_layer=per_layer,
                         seed_chunk=chunk)
