"""The port's simulator core: fabric model, compiled tables, the ECMP
walk, the routing strategies, link loads / FIM, the max-min fill and
the flowlet reordering cost, on PyTorch tensors; and the paper's
Algorithm 1 toolchain on the host: ECMP and static routing policies,
the hop-by-hop ``FlowTracer``, ``static_route_assignment``, the scalar
FIM and max-min model and the path report.  ``VectorTraceResult.
paths_for_seed`` and ``MonteCarloThroughput.pair_throughput_for_seed``
bridge the tensor results to the host tools."""

from .compile_fabric import CompiledFabric, DeviceTables, compile_fabric
from .ecmp import (
    FIELDS_5TUPLE, FIELDS_IP_PAIR, FIELDS_VXLAN, EcmpRouting, Forwarder,
    RoutingPolicy, StaticRouting, device_seed, ecmp_hash, flow_fields_matrix,
    flow_hash_fields,
)
from .fabric import (
    Device, Fabric, Link, build_multipod_fabric, build_paper_testbed, nic_ip,
    server_name,
)
from .fim import (
    LayerLoadStats, fim, layer_load_stats, link_flow_counts,
    max_min_throughput, per_layer_fim, per_pair_throughput,
)
from .flows import (
    FiveTuple, Flow, PairSpec, WorkloadDescription, bipartite_pairs,
    synthesize_flows, workload_from_flows,
)
from .placement import (
    balanced_port_spread, ring_edge_stats, static_route_assignment,
    topology_aware_ring,
)
from .reordering import (
    DEFAULT_RTT_SECONDS, IDEAL, ROCE_NACK, ROCE_NACK_ANCHORS, STRACK,
    STRACK_ANCHORS, TransportProfile, available_transports,
    calibrate_transport, flowlet_exposure, reordering_efficiency,
    resolve_transport, rtt_round_budget,
)
from .report import PathReport, analyze_paths
from .strategies import (
    ELEPHANT_MIN_BYTES, AdaptiveSpraying, CongestionAware, EcmpStrategy,
    PrimeSpraying, RoutingStrategy, WaveCongestionAware,
    available_strategies, register_strategy, resolve_strategy,
)
from .tracer import (
    ADHOC, PERSISTENT, ConnectionManager, DeviceChannel, FlowTracer,
    LatencyModel, TraceResult, auto_processes,
)
from .vector_sim import (
    DEMAND_BYTES, DEMAND_UNIFORM, EXACT, MURMUR, MonteCarloFim, SimSpec,
    VectorTraceResult, ecmp_walk, fim_from_counts, fim_vector,
    flow_demand_weights, monte_carlo_fim, normalize_seeds,
    resolve_flows, resolve_hash_backend, seed_chunk_size, segment_reduce,
    simulate_paths,
)
from .vector_throughput import (
    MonteCarloThroughput, batched_max_min, dedup_link_ids,
    flow_rates_from_flowlets, max_min_rates, monte_carlo_throughput,
    pair_rate_matrix, throughput_from_result,
)

__all__ = [
    "CompiledFabric", "DeviceTables", "compile_fabric",
    "FIELDS_5TUPLE", "FIELDS_IP_PAIR", "FIELDS_VXLAN", "EcmpRouting",
    "Forwarder", "RoutingPolicy", "StaticRouting", "device_seed",
    "ecmp_hash", "flow_fields_matrix", "flow_hash_fields",
    "Device", "Fabric", "Link", "build_multipod_fabric",
    "build_paper_testbed", "nic_ip", "server_name",
    "LayerLoadStats", "fim", "layer_load_stats", "link_flow_counts",
    "max_min_throughput", "per_layer_fim", "per_pair_throughput",
    "FiveTuple", "Flow", "PairSpec", "WorkloadDescription",
    "bipartite_pairs", "synthesize_flows", "workload_from_flows",
    "balanced_port_spread", "ring_edge_stats", "static_route_assignment",
    "topology_aware_ring",
    "DEFAULT_RTT_SECONDS", "IDEAL", "ROCE_NACK", "ROCE_NACK_ANCHORS",
    "STRACK", "STRACK_ANCHORS", "TransportProfile", "available_transports",
    "calibrate_transport", "flowlet_exposure", "reordering_efficiency",
    "resolve_transport", "rtt_round_budget",
    "PathReport", "analyze_paths",
    "ELEPHANT_MIN_BYTES", "AdaptiveSpraying", "CongestionAware",
    "EcmpStrategy", "PrimeSpraying", "RoutingStrategy",
    "WaveCongestionAware", "available_strategies", "register_strategy",
    "resolve_strategy",
    "ADHOC", "PERSISTENT", "ConnectionManager", "DeviceChannel",
    "FlowTracer", "LatencyModel", "TraceResult", "auto_processes",
    "DEMAND_BYTES", "DEMAND_UNIFORM", "EXACT", "MURMUR", "MonteCarloFim",
    "SimSpec", "VectorTraceResult", "ecmp_walk", "fim_from_counts",
    "fim_vector", "flow_demand_weights", "monte_carlo_fim",
    "normalize_seeds", "resolve_flows", "resolve_hash_backend",
    "seed_chunk_size", "segment_reduce", "simulate_paths",
    "MonteCarloThroughput", "batched_max_min", "dedup_link_ids",
    "flow_rates_from_flowlets", "max_min_rates", "monte_carlo_throughput",
    "pair_rate_matrix", "throughput_from_result",
]
