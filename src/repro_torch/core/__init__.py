"""The port's simulator core: fabric model, compiled tables, the ECMP
walk, the routing strategies, link loads / FIM, the max-min fill and
the flowlet reordering cost, on PyTorch tensors; the time-expanded
simulation of phased collectives (``simulate_timeline`` under static
and event timing, the departure-ordered drain ``departure_fill``) with
the LLM schedules it runs (``llm_workload``, ``hlo_flows``) and the
opt-in runtime contracts (``FLOWTRACER_CONTRACTS=1``); and the paper's
Algorithm 1 toolchain on the host: ECMP and static routing policies,
the hop-by-hop ``FlowTracer``, ``static_route_assignment``, the scalar
FIM and max-min model and the path report.  ``VectorTraceResult.
paths_for_seed`` and ``MonteCarloThroughput.pair_throughput_for_seed``
bridge the tensor results to the host tools."""

from .compile_fabric import CompiledFabric, DeviceTables, compile_fabric
from .contracts import CONTRACTS_ENV, ContractViolation, contracts_enabled
from .ecmp import (
    FIELDS_5TUPLE, FIELDS_IP_PAIR, FIELDS_VXLAN, EcmpRouting, Forwarder,
    RoutingPolicy, StaticRouting, device_seed, ecmp_hash, flow_fields_matrix,
    flow_hash_fields,
)
from .fabric import (
    HOST_TO_LEAF, LEAF_TO_HOST, LEAF_TO_SPINE, SPINE_TO_LEAF, Device, Fabric,
    Link, build_multipod_fabric, build_paper_testbed, nic_ip, server_name,
)
from .hlo_flows import (
    CollectiveOp, CollectiveSummary, EdgeClassCounts, collectives_to_flows,
    extract_collectives, shape_bytes, summarize, wire_and_operand,
)
from .fim import (
    LayerLoadStats, fim, layer_load_stats, link_flow_counts,
    max_min_throughput, per_layer_fim, per_pair_throughput,
)
from .flows import (
    FiveTuple, Flow, PairSpec, WorkloadDescription, bipartite_pairs,
    synthesize_flows, workload_from_flows,
)
from .llm_workload import (
    CH_BARRIER, CH_FSDP_AG, CH_FSDP_RS, CH_GRAD_AR, CH_MOE_A2A,
    SCHEDULE_DP_OVERLAP, SCHEDULE_SEQUENTIAL, LlmJobSpec,
    llm_collective_ops, llm_collective_phases, llm_flows, llm_schedule,
    llm_workload, multipod_llm_schedule, multipod_llm_workload,
    paper_testbed_llm_schedule, paper_testbed_llm_workload,
)
from .placement import (
    balanced_port_spread, ring_edge_stats, static_route_assignment,
    topology_aware_ring,
)
from .reordering import (
    DEFAULT_RTT_SECONDS, IDEAL, ROCE_NACK, ROCE_NACK_ANCHORS, STRACK,
    STRACK_ANCHORS, TransportProfile, available_transports,
    calibrate_transport, flowlet_exposure, register_transport,
    reordering_efficiency, resolve_transport, rtt_round_budget,
)
from .report import PathReport, analyze_paths
from .strategies import (
    ELEPHANT_MIN_BYTES, AdaptiveSpraying, CongestionAware, EcmpStrategy,
    PrimeSpraying, RoutingStrategy, WaveCongestionAware,
    available_strategies, register_strategy, resolve_strategy,
)
from .timeline import (
    StepResult, TimelineResult, TimelineStep, channel_name, flow_channel,
    known_channels, merged_step, partition_flows, register_channel,
    simulate_timeline, step_byte_totals,
)
from .tracer import (
    ADHOC, PERSISTENT, ConnectionManager, DeviceChannel, FlowTracer,
    LatencyModel, TraceResult, auto_processes,
)
from .vector_sim import (
    DEMAND_BYTES, DEMAND_UNIFORM, EXACT, MURMUR, TIMING_EVENT, TIMING_STATIC,
    MonteCarloFim, SimSpec, VectorTraceResult, ecmp_walk, fim_from_counts, fim_vector,
    flow_demand_weights, monte_carlo_fim, normalize_seeds,
    resolve_flows, resolve_hash_backend, seed_chunk_size, segment_reduce,
    simulate_paths,
)
from .vector_throughput import (
    DepartureFill, MonteCarloThroughput, batched_max_min, dedup_link_ids,
    departure_fill, flow_rates_from_flowlets, max_min_rates, monte_carlo_throughput,
    pair_rate_matrix, throughput_from_result,
)

__all__ = [
    "CompiledFabric", "DeviceTables", "compile_fabric",
    "CONTRACTS_ENV", "ContractViolation", "contracts_enabled",
    "FIELDS_5TUPLE", "FIELDS_IP_PAIR", "FIELDS_VXLAN", "EcmpRouting",
    "Forwarder", "RoutingPolicy", "StaticRouting", "device_seed",
    "ecmp_hash", "flow_fields_matrix", "flow_hash_fields",
    "HOST_TO_LEAF", "LEAF_TO_HOST", "LEAF_TO_SPINE", "SPINE_TO_LEAF",
    "Device", "Fabric", "Link", "build_multipod_fabric",
    "build_paper_testbed", "nic_ip", "server_name",
    "CollectiveOp", "CollectiveSummary", "EdgeClassCounts",
    "collectives_to_flows", "extract_collectives", "shape_bytes",
    "summarize", "wire_and_operand",
    "LayerLoadStats", "fim", "layer_load_stats", "link_flow_counts",
    "max_min_throughput", "per_layer_fim", "per_pair_throughput",
    "FiveTuple", "Flow", "PairSpec", "WorkloadDescription",
    "bipartite_pairs", "synthesize_flows", "workload_from_flows",
    "CH_BARRIER", "CH_FSDP_AG", "CH_FSDP_RS", "CH_GRAD_AR", "CH_MOE_A2A",
    "SCHEDULE_DP_OVERLAP", "SCHEDULE_SEQUENTIAL", "LlmJobSpec",
    "llm_collective_ops", "llm_collective_phases", "llm_flows",
    "llm_schedule", "llm_workload", "multipod_llm_schedule",
    "multipod_llm_workload", "paper_testbed_llm_schedule",
    "paper_testbed_llm_workload",
    "balanced_port_spread", "ring_edge_stats", "static_route_assignment",
    "topology_aware_ring",
    "DEFAULT_RTT_SECONDS", "IDEAL", "ROCE_NACK", "ROCE_NACK_ANCHORS",
    "STRACK", "STRACK_ANCHORS", "TransportProfile", "available_transports",
    "calibrate_transport", "flowlet_exposure", "register_transport",
    "reordering_efficiency", "resolve_transport", "rtt_round_budget",
    "PathReport", "analyze_paths",
    "ELEPHANT_MIN_BYTES", "AdaptiveSpraying", "CongestionAware",
    "EcmpStrategy", "PrimeSpraying", "RoutingStrategy",
    "WaveCongestionAware", "available_strategies", "register_strategy",
    "resolve_strategy",
    "StepResult", "TimelineResult", "TimelineStep", "channel_name",
    "flow_channel", "known_channels", "merged_step", "partition_flows",
    "register_channel", "simulate_timeline", "step_byte_totals",
    "ADHOC", "PERSISTENT", "ConnectionManager", "DeviceChannel",
    "FlowTracer", "LatencyModel", "TraceResult", "auto_processes",
    "DEMAND_BYTES", "DEMAND_UNIFORM", "EXACT", "MURMUR", "TIMING_EVENT",
    "TIMING_STATIC", "MonteCarloFim",
    "SimSpec", "VectorTraceResult", "ecmp_walk", "fim_from_counts",
    "fim_vector", "flow_demand_weights", "monte_carlo_fim",
    "normalize_seeds", "resolve_flows", "resolve_hash_backend",
    "seed_chunk_size", "segment_reduce", "simulate_paths",
    "DepartureFill", "MonteCarloThroughput", "batched_max_min",
    "dedup_link_ids", "departure_fill", "flow_rates_from_flowlets", "max_min_rates", "monte_carlo_throughput",
    "pair_rate_matrix", "throughput_from_result",
]
