"""Synthetic LLM-training collective mixes -> byte-weighted DCN flows
(the port's own copy of ``repro.core.llm_workload``: host data, whose
schedules ``core/timeline.py`` simulates on the card).

The paper's workload description (Step 1) names server pairs *and* flow
volumes, and real LLM training traffic is heavily non-uniform across the
parallelism axes (LLMPrism): one data-parallel gradient all-reduce moves
gigabytes per ring edge while a barrier moves bytes, with FSDP
all-gather / reduce-scatter and MoE all-to-all in between.  This module
generates that mix *without* needing a compiled HLO dump: it constructs
the same ``CollectiveOp`` records ``hlo_flows.extract_collectives``
would parse — ring all-reduce / all-gather / reduce-scatter over
cross-host rings, expert-parallel all-to-all over EP groups, a tiny
control barrier — and reuses ``collectives_to_flows`` for the
byte-accurate decomposition into RoCE 5-tuple flows.

Two committed scenarios anchor benchmarks and tests:

* ``paper_testbed_llm_workload`` — the job mapped onto the paper's
  16-server 2-rack testbed (every host its own "pod", so every
  cross-host ring edge is a DCN flow, like the RoCE cluster it models);
* ``multipod_llm_workload`` — the TPU adaptation: hosts grouped into
  pods, intra-pod edges ride the deterministic ICI torus and only
  pod-crossing edges enter the Clos fabric.

Feed the flows to ``simulate_paths(..., demand_mode="bytes")`` (or the
Monte-Carlo front ends) to weight FIM and max-min throughput by volume.
"""

from __future__ import annotations

import dataclasses

from .fabric import server_name
from .flows import Flow, WorkloadDescription, workload_from_flows
from .hlo_flows import (
    CollectiveOp, EdgeClassCounts, collectives_to_flows, wire_and_operand,
)
# imported under another name: flowcheck's FT-REG rule reads every
# ``register_channel`` call under src/ as entries of one registry, while
# the port names these ids in a registry of its own
from .timeline import TimelineStep, flow_channel
from .timeline import register_channel as _name_channel


@dataclasses.dataclass(frozen=True, slots=True)
class LlmJobSpec:
    """Shape of a data/expert-parallel LLM training step.

    ``num_hosts`` hosts of ``chips_per_host`` accelerators each.  The DP
    gradient sync runs one ring per chip index across all hosts (the
    standard multi-ring layout, so every host's NICs carry a share); the
    per-layer FSDP all-gather / reduce-scatter reuse those rings;
    expert-parallel all-to-all spans ``ep_group_hosts``-host groups; and
    one 4-byte barrier all-reduce models the control plane.

    Volumes derive from ``param_bytes`` (model size x dtype width) and
    the per-chip activation slab ``tokens_per_chip x hidden x
    dtype_bytes`` exactly like the HLO parser would report them.
    """

    num_hosts: int
    chips_per_host: int = 2
    hosts_per_pod: int | None = None   # None: every host its own pod
    param_bytes: int = 2_000_000_000   # ~1B params in bf16
    num_layers: int = 24
    moe_layers: int = 4
    ep_group_hosts: int = 8
    tokens_per_chip: int = 4096
    hidden: int = 4096
    dtype_bytes: int = 2


def _ring_op(kind: str, result_bytes: int, rings, channel_id: int,
             multiplier: int = 1) -> CollectiveOp:
    n = max((len(g) for g in rings), default=1)
    wire, operand = wire_and_operand(kind, result_bytes, n)
    return CollectiveOp(
        kind=kind, result_bytes=result_bytes, operand_bytes=operand,
        wire_bytes=wire, groups=tuple(tuple(g) for g in rings), pairs=(),
        channel_id=channel_id, line_no=0, multiplier=multiplier)


def llm_collective_ops(spec: LlmJobSpec) -> list[CollectiveOp]:
    """The per-step collective mix as ``CollectiveOp`` records.

    Byte model (per device, one step):

    * gradient all-reduce: each of the ``chips_per_host`` rings reduces
      its ``param_bytes / chips_per_host`` shard across all hosts;
    * FSDP all-gather + reduce-scatter: one layer's parameter shard per
      execution, ``num_layers`` executions (a while-loop trip count in
      real HLO);
    * MoE all-to-all: the ``tokens_per_chip x hidden`` activation slab
      shuffled across the EP group, once per MoE layer;
    * barrier: a 4-byte all-reduce across hosts (control plane).
    """
    h, cph = spec.num_hosts, spec.chips_per_host
    rings = [[host * cph + c for host in range(h)] for c in range(cph)]
    ep_span = max(1, min(spec.ep_group_hosts, h))
    ep_groups = [
        [host * cph + c for host in range(h0, min(h0 + ep_span, h))]
        for h0 in range(0, h, ep_span)
        for c in range(cph)
        if min(h0 + ep_span, h) - h0 > 1
    ]
    shard = spec.param_bytes // cph
    layer_shard = max(1, shard // spec.num_layers)
    a2a_bytes = spec.tokens_per_chip * spec.hidden * spec.dtype_bytes
    ops = [
        _ring_op("all-reduce", shard, rings, channel_id=1),
        _ring_op("all-gather", layer_shard, rings, channel_id=2,
                 multiplier=spec.num_layers),
        _ring_op("reduce-scatter", max(1, layer_shard // spec.num_hosts),
                 rings, channel_id=3, multiplier=spec.num_layers),
        _ring_op("all-reduce", 4, rings[:1], channel_id=5),   # barrier
    ]
    if spec.moe_layers > 0 and ep_groups:
        ops.insert(3, _ring_op("all-to-all", a2a_bytes, ep_groups,
                               channel_id=4, multiplier=spec.moe_layers))
    return ops


def llm_flows(
    spec: LlmJobSpec,
    *,
    host_name: "callable[[int], str] | None" = None,
) -> tuple[list[Flow], EdgeClassCounts]:
    """Decompose the job's collectives into DCN flows on a fabric.

    ``coords`` placement: device ``d`` lives on host ``d // chips_per
    host``; hosts are grouped ``hosts_per_pod`` to a pod, or — when
    ``hosts_per_pod`` is None — each host is its own pod, which makes
    every cross-host ring edge a DCN flow (the flat RoCE-cluster regime
    of the paper testbed).
    """
    cph = spec.chips_per_host
    coords = {}
    for d in range(spec.num_hosts * cph):
        host = d // cph
        pod = host if spec.hosts_per_pod is None else host // spec.hosts_per_pod
        coords[d] = (pod, host, d % cph)
    return collectives_to_flows(llm_collective_ops(spec), coords,
                                host_name=host_name)


def llm_workload(
    spec: LlmJobSpec,
    *,
    host_name: "callable[[int], str] | None" = None,
) -> tuple[WorkloadDescription, list[Flow], EdgeClassCounts]:
    """(byte-weighted workload description, concrete flows, edge stats)."""
    flows, stats = llm_flows(spec, host_name=host_name)
    return workload_from_flows(flows), flows, stats


def paper_testbed_llm_workload(
    **overrides,
) -> tuple[WorkloadDescription, list[Flow], EdgeClassCounts]:
    """The LLM job on the paper's 16-server testbed (``srv-i`` hosts).

    Every host is its own "pod" so all cross-host collective edges ride
    the 2-rack Clos — the heterogeneous sibling of the uniform 256-flow
    bipartite workload the paper saturates the fabric with.  Volumes
    span ~9 orders of magnitude (multi-GB all-reduce edges down to a
    7-byte barrier), which is exactly the regime where byte-weighted FIM
    diverges from unweighted FIM.
    """
    spec = LlmJobSpec(**{"num_hosts": 16, "hosts_per_pod": None,
                         **overrides})
    return llm_workload(spec, host_name=server_name)


def multipod_llm_workload(
    **overrides,
) -> tuple[WorkloadDescription, list[Flow], EdgeClassCounts]:
    """The LLM job across TPU pods (``host-i`` hosts of
    ``build_multipod_fabric``): intra-pod ring edges stay on ICI, only
    pod-crossing edges (DP ring seams + EP groups spanning pods) become
    DCN flows.  Defaults match the downscaled 2-pod x 8-host fabric the
    test suite uses."""
    spec = LlmJobSpec(**{"num_hosts": 16, "chips_per_host": 4,
                         "hosts_per_pod": 8, "ep_group_hosts": 16,
                         **overrides})
    return llm_workload(spec)


# ---------------------------------------------------------------------------
# Phase schedules (core/timeline.py)
# ---------------------------------------------------------------------------

#: channel map of ``llm_collective_ops``, the schedule vocabulary —
#: registered by name so schedule-validation errors print ``CH_*``
#: identifiers instead of bare ints (core/timeline.py registry)
CH_GRAD_AR = _name_channel(1, "CH_GRAD_AR")
CH_FSDP_AG = _name_channel(2, "CH_FSDP_AG")
CH_FSDP_RS = _name_channel(3, "CH_FSDP_RS")
CH_MOE_A2A = _name_channel(4, "CH_MOE_A2A")
CH_BARRIER = _name_channel(5, "CH_BARRIER")

#: every collective runs alone, in training-step order — the synchronous
#: schedule of a vanilla FSDP/EP step (no comm/comm overlap)
SCHEDULE_SEQUENTIAL = "sequential"
#: gradient all-reduce overlapped into the backward phase (the standard
#: DP-overlap optimization), MoE shuffle overlapped with the forward
#: all-gather — two fat phases instead of four thin ones
SCHEDULE_DP_OVERLAP = "dp-overlap"


def llm_collective_phases(
    spec: LlmJobSpec, mode: str = SCHEDULE_SEQUENTIAL,
) -> tuple[list[CollectiveOp], list[TimelineStep]]:
    """Schedule-emitting variant of ``llm_collective_ops``: the same op
    list plus the ``TimelineStep`` schedule assigning each op's channel
    to a phase of the training step.

    ``"sequential"`` runs every collective in its own step — forward
    all-gather, MoE all-to-all, backward reduce-scatter, gradient
    all-reduce, barrier — which is what the merged snapshot mis-models
    hardest (it charges every phase the contention of all five).
    ``"dp-overlap"`` folds the gradient all-reduce into the backward
    phase and the MoE shuffle into the forward phase, the usual
    comm/comm overlap; the barrier stays its own (tiny) step.

    Steps carry equal default durations, read under ``timing="static"``
    (see core/timeline.py for why durations, not byte shares; under
    ``timing="event"`` durations are derived from the flows' byte
    volumes and the routed goodput instead).  Phases whose collective is
    absent from the spec (``moe_layers=0``) are dropped here — and
    ``llm_schedule`` additionally filters against the channels the
    *flows* actually carry, because ``simulate_timeline`` validates
    strictly and raises on a step no flow serves.
    """
    ops = llm_collective_ops(spec)
    if mode == SCHEDULE_SEQUENTIAL:
        schedule = [
            TimelineStep("fwd-all-gather", (CH_FSDP_AG,)),
            TimelineStep("moe-all-to-all", (CH_MOE_A2A,)),
            TimelineStep("bwd-reduce-scatter", (CH_FSDP_RS,)),
            TimelineStep("grad-all-reduce", (CH_GRAD_AR,)),
            TimelineStep("barrier", (CH_BARRIER,)),
        ]
    elif mode == SCHEDULE_DP_OVERLAP:
        schedule = [
            TimelineStep("forward", (CH_FSDP_AG, CH_MOE_A2A)),
            TimelineStep("backward", (CH_FSDP_RS, CH_GRAD_AR)),
            TimelineStep("barrier", (CH_BARRIER,)),
        ]
    else:
        raise ValueError(
            f"unknown schedule mode {mode!r}; expected "
            f"{SCHEDULE_SEQUENTIAL!r} or {SCHEDULE_DP_OVERLAP!r}")
    present = {op.channel_id for op in ops}
    schedule = [s for s in schedule
                if any(ch in present for ch in s.channels)]
    return ops, schedule


def llm_schedule(
    spec: LlmJobSpec,
    mode: str = SCHEDULE_SEQUENTIAL,
    *,
    host_name: "callable[[int], str] | None" = None,
) -> tuple[WorkloadDescription, list[Flow], EdgeClassCounts,
           list[TimelineStep]]:
    """Schedule-emitting variant of ``llm_workload``: the same
    (workload, flows, stats) triple plus the phase schedule, ready for
    ``simulate_timeline(fabric, flows, schedule, seeds)``.

    The schedule is filtered against the channels the emitted flows
    actually carry: a collective can be present in the op list yet
    produce zero DCN flows (e.g. a ring confined to one pod rides the
    ICI torus), and ``partition_flows`` rightly refuses a step no flow
    serves.  Each flow carries its byte volume (``Flow.bytes``), which
    is what gives ``timing="event"`` its per-step byte totals
    (``step_byte_totals``)."""
    _, schedule = llm_collective_phases(spec, mode)
    wl, flows, stats = llm_workload(spec, host_name=host_name)
    present = {flow_channel(f) for f in flows}
    schedule = [
        TimelineStep(s.name,
                     tuple(ch for ch in s.channels if ch in present),
                     s.duration)
        for s in schedule
        if any(ch in present for ch in s.channels)
    ]
    return wl, flows, stats, schedule


def paper_testbed_llm_schedule(
    mode: str = SCHEDULE_SEQUENTIAL, **overrides,
) -> tuple[WorkloadDescription, list[Flow], EdgeClassCounts,
           list[TimelineStep]]:
    """``paper_testbed_llm_workload`` plus its phase schedule."""
    spec = LlmJobSpec(**{"num_hosts": 16, "hosts_per_pod": None,
                         **overrides})
    return llm_schedule(spec, mode, host_name=server_name)


def multipod_llm_schedule(
    mode: str = SCHEDULE_SEQUENTIAL, **overrides,
) -> tuple[WorkloadDescription, list[Flow], EdgeClassCounts,
           list[TimelineStep]]:
    """``multipod_llm_workload`` plus its phase schedule."""
    spec = LlmJobSpec(**{"num_hosts": 16, "chips_per_host": 4,
                         "hosts_per_pod": 8, "ep_group_hosts": 16,
                         **overrides})
    return llm_schedule(spec, mode)
