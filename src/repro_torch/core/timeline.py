"""Time-expanded simulation on the card: phased collectives over one
compiled fabric.

The PyTorch port of ``repro.core.timeline``.  A training step runs its
collectives in *phases* (forward all-gather, MoE all-to-all, backward
reduce-scatter, gradient all-reduce, barrier); merging them into one
steady-state snapshot overstates contention between collectives that
never share the wire and hides phase-local hotspots.  This module adds
the time axis:

* a schedule is a list of ``TimelineStep``s, each naming the collective
  *channels* (``CollectiveOp.channel_id``) active during that step and a
  relative ``duration`` (``weight`` is the deprecated alias);
* ``simulate_timeline`` partitions one flow list by channel, routes each
  step's active flow set independently over ONE shared
  ``compile_fabric`` pass, and scores each step with the *same* engines
  the merged front ends use — ``simulate_paths`` + ``fim_from_counts``
  + ``throughput_from_result`` — so a one-step schedule containing every
  channel reproduces the merged snapshot bit for bit;
* ``TimelineResult`` carries the per-step series and the time-weighted
  totals, as tensors on the simulation's device.

**Two timing models** (``SimSpec.timing``):

``timing="static"`` (default) weights steps by their exogenous
``TimelineStep.duration`` constants — relative durations, not byte
shares (with byte-proportional weights the time-weighted FIM could never
exceed the merged FIM, hiding exactly what this module exposes).

``timing="event"`` *derives* each step's duration from the routing
under test: every flow carries its byte volume (``Flow.bytes``), the
routed max-min goodput drains those bytes, flows **depart** as they
finish — each departure re-fills the survivors' rates over the
already-routed paths (``vector_throughput.departure_fill``, on the
card) — and the step ends when its slowest flow completes.  The result
then also carries absolute per-step start/end times, per-flow
completion times and the per-seed **job completion time**; the per-step
FIM/rate/goodput snapshots are computed exactly as in static mode.
Under event timing an ``AdaptiveSpraying`` strategy's round budget is
expressed in RTTs of the derived duration (``rtt_round_budget``): the
step is first routed with the round-1 allocation to derive its length,
then re-routed with the rounds that length affords.

Schedule emitters for the LLM scenarios live in ``core/llm_workload.py``.
Channel ids are named in the port's own registry (``register_channel``)
so schedule-validation errors name the ``CH_*`` vocabulary.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from collections.abc import Sequence

import numpy as np
import torch

from .compile_fabric import CompiledFabric, compile_fabric
from .fabric import Fabric
from .flows import Flow, WorkloadDescription
from .reordering import IDEAL, rtt_round_budget
from .strategies import AdaptiveSpraying
from .vector_sim import (
    MonteCarloFim, SimSpec, TIMING_EVENT, TIMING_STATIC, _UNSET,
    _weights_or_none, fim_from_counts, resolve_flows, resolve_spec,
    segment_reduce, simulate_paths,
)
from .vector_throughput import (
    MonteCarloThroughput, _fill_seeds, departure_fill, throughput_from_result,
)

_CHANNEL_RE = re.compile(r"#ch(\d+)$")

#: bytes -> gigabits (the unit ``departure_fill`` drains at Gb/s rates)
_GBITS_PER_BYTE = 8e-9

_WEIGHT_ALIAS_WARNED = False


# ---------------------------------------------------------------------------
# channel registry: ids -> CH_* names, for readable validation errors
# ---------------------------------------------------------------------------

_CHANNEL_NAMES: dict[int, str] = {}


def register_channel(channel_id: int, name: str, *,
                     replace: bool = False) -> int:
    """Name a collective channel id so schedule-validation errors read
    ``4 (CH_MOE_A2A)`` instead of a bare int.

    A duplicate id with a *different* name raises unless
    ``replace=True``; re-registering the same (id, name) pair is a
    no-op, so emitter modules can register at import time.  Returns the
    id."""
    cid = int(channel_id)
    if not replace and cid in _CHANNEL_NAMES and _CHANNEL_NAMES[cid] != name:
        raise ValueError(
            f"channel {cid} is already registered as "
            f"{_CHANNEL_NAMES[cid]!r} (known: {known_channels()}); "
            f"pass replace=True to rename it")
    _CHANNEL_NAMES[cid] = name
    return cid


def known_channels() -> list[str]:
    """The registered channel vocabulary, sorted by id, as
    ``"<id> (<name>)"`` strings — what validation errors print."""
    return [f"{cid} ({name})" for cid, name in sorted(_CHANNEL_NAMES.items())]


def channel_name(channel_id: int) -> str:
    """``"<id> (<name>)"`` when registered, the bare id otherwise."""
    name = _CHANNEL_NAMES.get(channel_id)
    return f"{channel_id} ({name})" if name is not None else str(channel_id)


# ---------------------------------------------------------------------------
# schedule vocabulary
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, slots=True, init=False)
class TimelineStep:
    """One schedule step: the channels on the wire and how long they hold it.

    ``channels`` are ``CollectiveOp.channel_id`` values (the flow labels
    carry them as the ``#ch<N>`` suffix ``collectives_to_flows`` emits);
    a channel may appear in several steps.  ``duration`` is the step's
    relative duration under ``timing="static"`` and is ignored under
    ``timing="event"``.  ``weight=`` is accepted as a deprecated alias
    of ``duration=`` (one warning per process; passing both raises)."""

    name: str
    channels: tuple[int, ...]
    duration: float

    def __init__(self, name: str, channels: Sequence[int],
                 duration: float | None = None, *,
                 weight: float | None = None):
        if weight is not None:
            if duration is not None:
                raise TypeError(
                    "pass duration= only (weight= is its deprecated "
                    "alias), not both")
            global _WEIGHT_ALIAS_WARNED
            if not _WEIGHT_ALIAS_WARNED:
                warnings.warn(
                    "TimelineStep(weight=...) is deprecated; the field "
                    "is named duration (identical semantics: relative "
                    "step length under timing='static')",
                    DeprecationWarning, stacklevel=2)
                _WEIGHT_ALIAS_WARNED = True
            duration = weight
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "channels", tuple(channels))
        object.__setattr__(self, "duration",
                           1.0 if duration is None else float(duration))
        if not self.channels:
            raise ValueError(f"step {self.name!r} has no channels")
        if not self.duration > 0:
            raise ValueError(
                f"step {self.name!r} duration must be > 0, "
                f"got {self.duration}")

    @property
    def weight(self) -> float:
        """Deprecated alias of ``duration``."""
        return self.duration


def merged_step(schedule: Sequence[TimelineStep],
                name: str = "merged") -> TimelineStep:
    """The degenerate one-step schedule: every channel of ``schedule``
    active at once — the merged-snapshot view, kept as the anchor."""
    seen: dict[int, None] = {}
    for step in schedule:
        for ch in step.channels:
            seen.setdefault(ch, None)
    return TimelineStep(name=name, channels=tuple(seen))


def flow_channel(flow: Flow) -> int | None:
    """The collective channel id a flow belongs to, parsed from the
    ``#ch<N>`` label suffix ``collectives_to_flows`` writes.  ``None``
    for unlabeled flows."""
    m = _CHANNEL_RE.search(flow.label)
    return int(m.group(1)) if m else None


def partition_flows(
    flows: Sequence[Flow], schedule: Sequence[TimelineStep]
) -> list[list[Flow]]:
    """Each step's active flow sublist, in original flow order (which
    keeps the one-step schedule bit-identical to the merged run).

    Validation is strict in both directions: flows whose channel appears
    in no step raise, flows without a ``#ch<N>`` label raise, and a step
    referencing a channel no flow carries raises, naming the known
    channels (``register_channel`` vocabulary).
    """
    if not flows:
        raise ValueError(
            "no flows to partition: the flow list is empty, so every "
            "schedule step would resolve to an empty flow set")
    chans = [flow_channel(f) for f in flows]
    unlabeled = sum(c is None for c in chans)
    if unlabeled:
        raise ValueError(
            f"{unlabeled} flows carry no '#ch<N>' label — "
            f"time-expanded simulation needs collective-derived flows "
            f"(see core/llm_workload.py)")
    present = {c for c in chans if c is not None}
    for step in schedule:
        missing = sorted(set(step.channels) - present)
        if missing:
            raise ValueError(
                f"step {step.name!r} references channel(s) "
                f"{[channel_name(c) for c in missing]} that no flow "
                f"carries; known channels here: "
                f"{[channel_name(c) for c in sorted(present)]} "
                f"(registered vocabulary: {known_channels()})")
    covered = {ch for step in schedule for ch in step.channels}
    stray = sorted({c for c in present if c not in covered})
    if stray:
        raise ValueError(
            f"flows on channels {stray} appear in no schedule step "
            f"(steps cover {sorted(covered)}); every collective must be "
            f"scheduled somewhere")
    return [[f for f, c in zip(flows, chans) if c in step.channels]
            for step in schedule]


def step_byte_totals(flows: Sequence[Flow],
                     schedule: Sequence[TimelineStep]) -> np.ndarray:
    """(K,) total wire bytes active during each step, with
    ``partition_flows``'s validation; an overlapped flow counts toward
    every step it is active in.  Host data, like the flows."""
    parts = partition_flows(flows, schedule)
    return np.array([float(sum(f.bytes for f in sub)) for sub in parts],
                    np.float64)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


def _stats(v: np.ndarray) -> dict[str, float]:
    return {
        "mean": float(v.mean()),
        "std": float(v.std()),
        "min": float(v.min()),
        "p50": float(np.percentile(v, 50)),
        "max": float(v.max()),
    }


@dataclasses.dataclass
class StepResult:
    """One step's scoring: the routed flow set, FIM distribution and
    throughput/goodput distribution — what the merged front ends would
    report had this step been the whole workload.

    Under ``timing="event"`` ``completion`` is the per-(flow, seed)
    completion time in seconds *relative to the step's start* and
    ``duration`` the per-seed step duration; ``drain_rounds`` and
    ``fill_rounds`` count the departure drain's rounds and the freeze
    rounds of its re-fills.  ``None`` / 0 under static timing."""

    step: TimelineStep
    flows: list[Flow]
    fim: MonteCarloFim
    throughput: MonteCarloThroughput
    completion: torch.Tensor | None = None   # (N, S) seconds from step start
    duration: torch.Tensor | None = None     # (S,) seconds
    drain_rounds: int = 0
    fill_rounds: int = 0

    @property
    def mean_goodput(self) -> torch.Tensor:
        """(S,) mean per-flow goodput under each seed."""
        return self.throughput.goodput.mean(0)

    @property
    def mean_rate(self) -> torch.Tensor:
        """(S,) mean per-flow max-min rate under each seed."""
        return self.throughput.rates.mean(0)


@dataclasses.dataclass
class TimelineResult:
    """Per-step series + time-weighted totals of a scheduled simulation
    (tensors on the simulation's device).

    ``fim`` is the duration-weighted mean of the per-step aggregate FIM;
    ``goodput`` / ``rates`` the duration-weighted mean of per-step mean
    flow goodput/rate.  For a one-step schedule every series is the
    step's own, bit for bit.

    Under ``timing="static"`` the weights are the normalized
    ``TimelineStep.duration`` constants.  Under ``timing="event"`` each
    seed has its own derived step durations, so the totals are weighted
    per seed, and ``step_durations`` / ``step_starts`` / ``step_ends``
    are ``(K, S)`` seconds (steps back to back in schedule order) and
    ``job_completion`` the per-seed end of the last step; ``weights``
    then reports the seed-mean duration shares."""

    seeds: np.ndarray                   # (S,)
    steps: list[StepResult]
    weights: torch.Tensor               # (K,) normalized step durations
    fim: torch.Tensor                   # (S,) time-weighted aggregate FIM
    goodput: torch.Tensor               # (S,) time-weighted mean goodput
    rates: torch.Tensor                 # (S,) time-weighted mean rate
    timing: str = TIMING_STATIC
    step_durations: torch.Tensor | None = None   # (K, S) seconds (event)
    step_starts: torch.Tensor | None = None      # (K, S) absolute seconds
    step_ends: torch.Tensor | None = None        # (K, S) absolute seconds
    job_completion: torch.Tensor | None = None   # (S,) seconds (event)

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def step_fim(self) -> torch.Tensor:
        """(K, S) per-step aggregate FIM series."""
        return torch.stack([s.fim.aggregate for s in self.steps])

    def flow_completion(self, step_index: int) -> torch.Tensor:
        """(N, S) *absolute* completion times (seconds from job start)
        of step ``step_index``'s flows.  Event timing only."""
        if self.timing != TIMING_EVENT:
            raise ValueError(
                "flow_completion is only defined under timing='event' "
                f"(this result is timing={self.timing!r})")
        return (self.step_starts[step_index]
                + self.steps[step_index].completion)

    def summary(self) -> dict[str, dict[str, float]]:
        rows: dict[str, torch.Tensor] = {
            "fim": self.fim,
            "goodput": self.goodput,
            "rate": self.rates,
        }
        if self.job_completion is not None:
            rows["job_completion_s"] = self.job_completion
        for sr in self.steps:
            rows[f"fim[{sr.step.name}]"] = sr.fim.aggregate
            rows[f"goodput[{sr.step.name}]"] = sr.mean_goodput
            if sr.duration is not None:
                rows[f"duration_s[{sr.step.name}]"] = sr.duration
        return {name: _stats(v.cpu().numpy().astype(np.float64).ravel())
                for name, v in rows.items()}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _score_step(comp, sub, seeds, s, layers, only_used_leaves):
    """Route + score one step's flow set: the pipeline of the merged
    front ends, with the flowlet fill shared between the throughput
    snapshot and (under event timing) the departure drain."""
    res = simulate_paths(comp, sub, seeds, spec=s)
    agg, per_layer = fim_from_counts(
        res.link_flow_counts(), comp,
        layers=layers, only_used_leaves=only_used_leaves)
    flowlet_rates, rounds = _fill_seeds(
        res.link_ids, comp.to(s.device).link_gbps,
        _weights_or_none(res.column_weights()))
    tp = throughput_from_result(res, transport=s.transport,
                                flowlet_rates=flowlet_rates)
    tp.seed_chunk, tp.fill_rounds = res.num_seeds, rounds
    fim = MonteCarloFim(seeds=res.seeds, aggregate=agg, per_layer=per_layer,
                        seed_chunk=res.num_seeds)
    return res, fim, tp, flowlet_rates


def _event_step_times(res, tp, flowlet_rates):
    """((N, S) per-flow completion seconds, the drain) of one routed
    step under the departure-ordered drain.

    Each tensor column drains its byte share — the parent flow's bytes
    times the flowlet's demand fraction — at goodput = max-min rate x
    transport efficiency (the committed routing's exposure, held fixed
    across departures).  The per-flow gigabits are built on the host
    once and cross to the device; the full-set fill is reused as round
    1.  Byte volumes are floored at one byte, so every step's duration
    stays positive."""
    fi = res.flow_index
    dev = res.link_ids.device
    bytes_f = np.array([f.bytes for f in res.flows], np.float64)
    gbits_f = torch.from_numpy(
        np.maximum(bytes_f, 1.0) * _GBITS_PER_BYTE).to(dev)
    col_gbits = gbits_f[fi] * res.demand
    dep = departure_fill(
        res.link_ids, res.compiled.to(dev).link_gbps, col_gbits,
        weights=_weights_or_none(res.column_weights()),
        efficiency=tp.efficiency[fi],
        assume_unique=True, initial_rates=flowlet_rates, device=dev)
    # a flow completes when its last flowlet does
    completion = segment_reduce(dep.completion, fi, res.num_flows,
                                "amax", 0.0)
    return completion, dep


def simulate_timeline(
    fabric: Fabric | CompiledFabric,
    workload: WorkloadDescription | Sequence[Flow],
    schedule: Sequence[TimelineStep],
    seeds: Sequence[int] | np.ndarray,
    *,
    spec: SimSpec | None = None,
    fields=_UNSET,
    hash_backend=_UNSET,
    strategy=_UNSET,
    demand_mode=_UNSET,
    transport=_UNSET,
    layers: Sequence[str] | None = None,
    only_used_leaves: bool = False,
    device=_UNSET,
    timing=_UNSET,
    max_hops=_UNSET,
) -> TimelineResult:
    """Simulate a phase schedule step by step over one compiled fabric,
    on the card unless ``device="cpu"``.

    Every step routes ONLY its active flows through the
    ``simulate_paths`` → ``fim_from_counts`` → ``throughput_from_result``
    pipeline of the merged front ends, under one ``SimSpec`` (``spec=``
    or the kwargs, not both; a strategy name is resolved once and
    shared by every step).  The compiled fabric is shared across steps.

    ``timing="static"`` (default) weights the totals by the
    ``TimelineStep.duration`` constants.  ``timing="event"`` derives
    each step's duration from the routed goodput (``departure_fill``)
    and fills in the absolute time axis.  The per-step snapshots are
    computed identically under both timings, so a one-step schedule is
    bit-identical across timings and to the merged front ends.  Under
    event timing an ``AdaptiveSpraying`` step is first routed at round 1
    to derive its duration, then re-routed with the round budget that
    duration affords in transport RTTs (``rtt_round_budget``).

    Schedules are validated strictly (``partition_flows``).
    """
    s = resolve_spec(spec, dict(
        fields=fields, hash_backend=hash_backend, strategy=strategy,
        demand_mode=demand_mode, transport=transport, device=device,
        timing=timing, max_hops=max_hops))
    comp = (fabric if isinstance(fabric, CompiledFabric)
            else compile_fabric(fabric))
    flows = resolve_flows(comp, workload)
    if not schedule:
        raise ValueError("schedule must contain at least one step")
    parts = partition_flows(flows, schedule)
    event = s.timing == TIMING_EVENT
    # AdaptiveSpraying under event timing: probe with the round-1
    # allocation first, then spend the RTT budget the duration affords
    adaptive = (event and isinstance(s.strategy, AdaptiveSpraying)
                and s.strategy.rounds > 1)
    if adaptive:
        rtt = (s.transport.rtt_seconds if s.transport is not None
               else IDEAL.rtt_seconds)
    steps: list[StepResult] = []
    durations: list = []
    for step, sub in zip(schedule, parts):
        spec_k = (dataclasses.replace(s, strategy=s.strategy.with_rounds(1))
                  if adaptive else s)
        res, fim_k, tp, fr = _score_step(comp, sub, seeds, spec_k,
                                         layers, only_used_leaves)
        if not event:
            steps.append(StepResult(step=step, flows=sub, fim=fim_k,
                                    throughput=tp))
            durations.append(step.duration)
            continue
        completion, dep = _event_step_times(res, tp, fr)
        if adaptive:
            budget = rtt_round_budget(float(dep.duration.mean()), rtt,
                                      s.strategy.rounds)
            if budget > 1:
                spec_k = dataclasses.replace(
                    s, strategy=s.strategy.with_rounds(budget))
                res, fim_k, tp, fr = _score_step(
                    comp, sub, seeds, spec_k, layers, only_used_leaves)
                completion, dep = _event_step_times(res, tp, fr)
        steps.append(StepResult(step=step, flows=sub, fim=fim_k,
                                throughput=tp, completion=completion,
                                duration=dep.duration,
                                drain_rounds=dep.rounds,
                                fill_rounds=dep.fill_rounds))
        durations.append(dep.duration)
    f64 = torch.float64
    dev = s.device
    seeds_out = steps[0].fim.seeds
    if not event:
        w = torch.tensor(durations, dtype=f64, device=dev)
        w = w / w.sum()
        if len(steps) == 1:
            # the degenerate anchor: no weighting arithmetic may perturb it
            fim = steps[0].fim.aggregate
            goodput = steps[0].mean_goodput
            rates = steps[0].mean_rate
        else:
            fim, goodput, rates = (
                torch.einsum("k,ks->s", w, torch.stack(series))
                for series in ([s_.fim.aggregate for s_ in steps],
                               [s_.mean_goodput for s_ in steps],
                               [s_.mean_rate for s_ in steps]))
        return TimelineResult(seeds=seeds_out, steps=steps, weights=w,
                              fim=fim, goodput=goodput, rates=rates,
                              timing=s.timing)
    dmat = torch.stack(durations)          # (K, S) derived seconds
    ends = torch.cumsum(dmat, 0)           # steps run back to back
    starts = ends - dmat
    job = ends[-1]
    w = dmat.mean(1)
    w = w / w.sum()
    if len(steps) == 1:
        # the degenerate anchor: no weighting arithmetic may perturb it
        fim = steps[0].fim.aggregate
        goodput = steps[0].mean_goodput
        rates = steps[0].mean_rate
    else:
        wks = dmat / dmat.sum(0)           # per-seed duration shares
        fim, goodput, rates = (
            (wks * torch.stack(series)).sum(0)
            for series in ([s_.fim.aggregate for s_ in steps],
                           [s_.mean_goodput for s_ in steps],
                           [s_.mean_rate for s_ in steps]))
    return TimelineResult(seeds=seeds_out, steps=steps, weights=w, fim=fim,
                          goodput=goodput, rates=rates, timing=s.timing,
                          step_durations=dmat, step_starts=starts,
                          step_ends=ends, job_completion=job)
