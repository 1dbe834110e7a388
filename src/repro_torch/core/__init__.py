"""The port's simulator core: fabric model, compiled tables, the ECMP
walk, the routing strategies, link loads / FIM, the max-min fill and
the flowlet reordering cost, on PyTorch tensors."""

from .compile_fabric import CompiledFabric, DeviceTables, compile_fabric
from .ecmp import (
    FIELDS_5TUPLE, FIELDS_IP_PAIR, FIELDS_VXLAN, Forwarder, ecmp_hash,
    flow_fields_matrix, flow_hash_fields,
)
from .fabric import (
    Device, Fabric, Link, build_multipod_fabric, build_paper_testbed, nic_ip,
    server_name,
)
from .flows import (
    FiveTuple, Flow, PairSpec, WorkloadDescription, bipartite_pairs,
    synthesize_flows, workload_from_flows,
)
from .reordering import (
    DEFAULT_RTT_SECONDS, IDEAL, ROCE_NACK, ROCE_NACK_ANCHORS, STRACK,
    STRACK_ANCHORS, TransportProfile, available_transports,
    calibrate_transport, flowlet_exposure, reordering_efficiency,
    resolve_transport, rtt_round_budget,
)
from .strategies import (
    ELEPHANT_MIN_BYTES, AdaptiveSpraying, CongestionAware, EcmpStrategy,
    PrimeSpraying, RoutingStrategy, WaveCongestionAware,
    available_strategies, register_strategy, resolve_strategy,
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
    "FIELDS_5TUPLE", "FIELDS_IP_PAIR", "FIELDS_VXLAN", "Forwarder",
    "ecmp_hash", "flow_fields_matrix", "flow_hash_fields",
    "Device", "Fabric", "Link", "build_multipod_fabric",
    "build_paper_testbed", "nic_ip", "server_name",
    "FiveTuple", "Flow", "PairSpec", "WorkloadDescription",
    "bipartite_pairs", "synthesize_flows", "workload_from_flows",
    "DEFAULT_RTT_SECONDS", "IDEAL", "ROCE_NACK", "ROCE_NACK_ANCHORS",
    "STRACK", "STRACK_ANCHORS", "TransportProfile", "available_transports",
    "calibrate_transport", "flowlet_exposure", "reordering_efficiency",
    "resolve_transport", "rtt_round_budget",
    "ELEPHANT_MIN_BYTES", "AdaptiveSpraying", "CongestionAware",
    "EcmpStrategy", "PrimeSpraying", "RoutingStrategy",
    "WaveCongestionAware", "available_strategies", "register_strategy",
    "resolve_strategy",
    "DEMAND_BYTES", "DEMAND_UNIFORM", "EXACT", "MURMUR", "MonteCarloFim",
    "SimSpec", "VectorTraceResult", "ecmp_walk", "fim_from_counts",
    "fim_vector", "flow_demand_weights", "monte_carlo_fim",
    "normalize_seeds", "resolve_flows", "resolve_hash_backend",
    "seed_chunk_size", "segment_reduce", "simulate_paths",
    "MonteCarloThroughput", "batched_max_min", "dedup_link_ids",
    "flow_rates_from_flowlets", "max_min_rates", "monte_carlo_throughput",
    "pair_rate_matrix", "throughput_from_result",
]
