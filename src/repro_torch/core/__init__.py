"""The port's simulator core: fabric model, compiled tables, the ECMP
walk, link loads / FIM and the max-min fill, on PyTorch tensors."""

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
    IDEAL, ROCE_NACK, STRACK, TransportProfile, calibrate_transport,
    resolve_transport,
)
from .vector_sim import (
    EXACT, MURMUR, MonteCarloFim, SimSpec, VectorTraceResult, ecmp_walk,
    fim_from_counts, monte_carlo_fim, normalize_seeds, seed_chunk_size,
    simulate_paths,
)
from .vector_throughput import (
    MonteCarloThroughput, batched_max_min, dedup_link_ids, max_min_rates,
    monte_carlo_throughput, pair_rate_matrix, throughput_from_result,
)

__all__ = [
    "CompiledFabric", "DeviceTables", "compile_fabric",
    "FIELDS_5TUPLE", "FIELDS_IP_PAIR", "FIELDS_VXLAN", "Forwarder",
    "ecmp_hash", "flow_fields_matrix", "flow_hash_fields",
    "Device", "Fabric", "Link", "build_multipod_fabric",
    "build_paper_testbed", "nic_ip", "server_name",
    "FiveTuple", "Flow", "PairSpec", "WorkloadDescription",
    "bipartite_pairs", "synthesize_flows", "workload_from_flows",
    "IDEAL", "ROCE_NACK", "STRACK", "TransportProfile",
    "calibrate_transport", "resolve_transport",
    "EXACT", "MURMUR", "MonteCarloFim", "SimSpec", "VectorTraceResult",
    "ecmp_walk", "fim_from_counts", "monte_carlo_fim", "normalize_seeds",
    "seed_chunk_size", "simulate_paths",
    "MonteCarloThroughput", "batched_max_min", "dedup_link_ids",
    "max_min_rates", "monte_carlo_throughput", "pair_rate_matrix",
    "throughput_from_result",
]
