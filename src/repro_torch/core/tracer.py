"""FlowTracer: the paper's Algorithm 1.

Parallel hop-by-hop path discovery for every flow of a workload:

  * the workload's (s, d) pairs are divided among P processes (Step 2-3);
  * each process opens communication channels to the devices it needs
    (Step 4) and retrieves + filters the per-pair flow 5-tuples (Step 5,
    the ``ss`` / NIC-driver query);
  * the pair's flows are divided among T threads, each of which walks the
    flow hop-by-hop (Step 5, right side of Fig. 1): query the current
    device for the flow's egress interface (the switch's ECMP
    hash-visibility CLI), follow the topology file to the next device's
    ingress interface, repeat until the destination server is reached;
  * results are compiled by the Path Analyzer (report.py, Steps 6-7).

Device access goes through ``DeviceChannel`` objects whose connection
setup/query costs reproduce the paper's three SSH strategies (Fig. 5):
ADHOC (connect per query), PERSISTENT (one connection per device reused),
and persistent+threads (= the paper's Parallel+Persistent).  Latencies are
injected by a ``LatencyModel`` so Fig. 4/5 scaling is measurable on any
machine; set it to zero for pure-logic tests.

The port's own copy of ``repro.core.tracer`` (the port imports nothing of
``repro``); keep the two in step.  Like the reference it is host Python
and imports no torch itself, so worker processes only walk the fabric's
dicts: they never touch torch or a CUDA context the parent may hold.
Unlike the reference, the process pool spawns its workers (see
``FlowTracer.trace``), so a script that traces with ``num_processes > 1``
runs its work under ``if __name__ == "__main__":``.
The vector engine's bridge to it is ``VectorTraceResult.paths_for_seed``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from collections.abc import Sequence

from .ecmp import RoutingPolicy
from .fabric import Fabric, Link, SERVER
from .flows import Flow, PairSpec, WorkloadDescription

ADHOC = "adhoc"
PERSISTENT = "persistent"

Path = list[Link]


@dataclasses.dataclass(frozen=True, slots=True)
class LatencyModel:
    """Synthetic device-access costs (seconds).  ``connect_s`` dominates in
    practice — that is the entire point of the paper's Fig. 5."""

    connect_s: float = 0.0
    query_s: float = 0.0

    def sleep_connect(self):
        if self.connect_s:
            time.sleep(self.connect_s)

    def sleep_query(self):
        if self.query_s:
            time.sleep(self.query_s)


@dataclasses.dataclass
class ChannelStats:
    connects: int = 0
    queries: int = 0

    def merge(self, other: "ChannelStats") -> None:
        self.connects += other.connects
        self.queries += other.queries


class DeviceChannel:
    """An (SSH) session to one device.  ``query_egress`` is the switch
    hash-visibility CLI / server route+driver lookup."""

    def __init__(self, device: str, routing: RoutingPolicy,
                 latency: LatencyModel, stats: ChannelStats):
        self.device = device
        self.routing = routing
        self.latency = latency
        self.stats = stats
        self._open = False

    def connect(self) -> "DeviceChannel":
        self.latency.sleep_connect()
        self.stats.connects += 1
        self._open = True
        return self

    def query_egress(self, flow: Flow, ingress_port: str | None) -> Link:
        assert self._open, "channel used before connect()"
        self.latency.sleep_query()
        self.stats.queries += 1
        return self.routing.egress(self.device, flow, ingress_port)

    def query_flows(self, flows: Sequence[Flow], pair: PairSpec) -> list[Flow]:
        """Server-side 5-tuple retrieval (ss / NIC driver)."""
        assert self._open
        self.latency.sleep_query()
        self.stats.queries += 1
        return [f for f in flows if f.src == pair.src and f.dst == pair.dst]

    def close(self) -> None:
        self._open = False


class ConnectionManager:
    """Per-thread channel cache implementing the paper's SSH strategies."""

    def __init__(self, routing: RoutingPolicy, latency: LatencyModel,
                 mode: str = PERSISTENT):
        assert mode in (ADHOC, PERSISTENT), mode
        self.routing = routing
        self.latency = latency
        self.mode = mode
        self._local = threading.local()
        self._lock = threading.Lock()
        self._all_stats: list[ChannelStats] = []

    def _cache(self) -> dict[str, DeviceChannel]:
        if not hasattr(self._local, "chans"):
            self._local.chans = {}
        return self._local.chans

    def channel(self, device: str) -> DeviceChannel:
        if self.mode == ADHOC:
            # fresh connection, caller is expected to close after each use
            return DeviceChannel(device, self.routing, self.latency,
                                 self._thread_stats()).connect()
        cache = self._cache()
        if device not in cache:
            cache[device] = DeviceChannel(device, self.routing, self.latency,
                                          self._thread_stats()).connect()
        return cache[device]

    def _thread_stats(self) -> ChannelStats:
        if not hasattr(self._local, "stats"):
            self._local.stats = ChannelStats()
            with self._lock:
                self._all_stats.append(self._local.stats)
        return self._local.stats

    def release(self, chan: DeviceChannel) -> None:
        if self.mode == ADHOC:
            chan.close()

    def totals(self) -> ChannelStats:
        total = ChannelStats()
        for s in getattr(self, "_all_stats", []):
            total.merge(s)
        return total


@dataclasses.dataclass
class TraceResult:
    """Output of Algorithm 1 + bookkeeping for the scalability analysis."""

    paths: dict[int, Path]
    flows: list[Flow]
    wall_time_s: float
    stats: ChannelStats
    num_processes: int
    num_threads: int

    def merge(self, other: "TraceResult") -> None:
        self.paths.update(other.paths)
        self.flows.extend(other.flows)
        self.stats.merge(other.stats)


class FlowTracer:
    """Paper Algorithm 1.  ``flows`` is the ground-truth traffic the fabric
    carries (what the NIC driver / ss would report when queried)."""

    def __init__(
        self,
        fabric: Fabric,
        routing: RoutingPolicy,
        workload: WorkloadDescription,
        flows: Sequence[Flow],
        *,
        num_processes: int = 1,
        num_threads: int = 1,
        connection_mode: str = PERSISTENT,
        latency: LatencyModel | None = None,
        max_hops: int = 16,
    ):
        self.fabric = fabric
        self.routing = routing
        self.workload = workload
        self.flows = list(flows)
        self.num_processes = max(1, num_processes)
        self.num_threads = max(1, num_threads)
        self.connection_mode = connection_mode
        self.latency = latency or LatencyModel()
        self.max_hops = max_hops

    # -- hop-by-hop discovery for one flow (paper Section III-B) ----------
    def _trace_flow(self, flow: Flow, conns: ConnectionManager) -> Path:
        path: Path = []
        device, ingress = flow.src, None
        for _ in range(self.max_hops):
            chan = conns.channel(device)
            link = chan.query_egress(flow, ingress)
            conns.release(chan)
            path.append(link)
            nxt = link.dst
            if self.fabric.kind(nxt) == SERVER:
                if nxt != flow.dst:
                    raise RuntimeError(
                        f"flow {flow.flow_id} terminated at {nxt}, expected {flow.dst}"
                    )
                return path
            # topology file: egress interface -> next hop's ingress interface
            device, ingress = nxt, link.dst_port
        raise RuntimeError(f"flow {flow.flow_id} exceeded {self.max_hops} hops")

    # -- per-pair tracing: retrieve + filter + fan out over threads --------
    def _trace_pairs(self, pairs: Sequence[PairSpec]) -> TraceResult:
        t0 = time.perf_counter()
        conns = ConnectionManager(self.routing, self.latency, self.connection_mode)
        paths: dict[int, Path] = {}
        all_flows: list[Flow] = []
        lock = threading.Lock()

        def work(flow: Flow) -> None:
            p = self._trace_flow(flow, conns)
            with lock:
                paths[flow.flow_id] = p

        # One pool for the whole process: threads (and their persistent
        # channel caches) live across pairs, matching long-lived SSH
        # sessions in the Parallel+Persistent configuration.
        pool = (
            ThreadPoolExecutor(max_workers=self.num_threads)
            if self.num_threads > 1 else None
        )
        try:
            for pair in pairs:
                src_chan = conns.channel(pair.src)
                pair_flows = src_chan.query_flows(self.flows, pair)
                conns.release(src_chan)
                pair_flows = self.workload.filter(pair_flows)  # Alg.1 line 7
                all_flows.extend(pair_flows)
                if pool is None:
                    for f in pair_flows:
                        work(f)
                else:
                    list(pool.map(work, pair_flows))
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return TraceResult(
            paths=paths,
            flows=all_flows,
            wall_time_s=time.perf_counter() - t0,
            stats=conns.totals(),
            num_processes=1,
            num_threads=self.num_threads,
        )

    # -- Algorithm 1 entry point -------------------------------------------
    def trace(self) -> TraceResult:
        t0 = time.perf_counter()
        pairs = self.workload.pairs
        if self.num_processes == 1 or len(pairs) <= 1:
            result = self._trace_pairs(pairs)
        else:
            shards = [pairs[i :: self.num_processes] for i in range(self.num_processes)]
            shards = [s for s in shards if s]
            # spawned, not forked: the port's callers hold torch's thread
            # pools and often a CUDA context, and a child forked from a
            # threaded process can deadlock (Python 3.12 warns of it)
            with ProcessPoolExecutor(
                    max_workers=len(shards),
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                results = list(
                    ex.map(
                        _process_entry,
                        [
                            (self.fabric, self.routing, self.workload, self.flows,
                             shard, self.num_threads, self.connection_mode,
                             self.latency, self.max_hops)
                            for shard in shards
                        ],
                    )
                )
            result = results[0]
            for r in results[1:]:
                result.merge(r)
        result.wall_time_s = time.perf_counter() - t0
        result.num_processes = self.num_processes
        result.num_threads = self.num_threads
        return result


def _process_entry(payload) -> TraceResult:
    (fabric, routing, workload, flows, shard, num_threads, mode, latency,
     max_hops) = payload
    tracer = FlowTracer(
        fabric, routing, WorkloadDescription(pairs=list(shard),
                                             filter_protocols=workload.filter_protocols),
        flows, num_threads=num_threads, connection_mode=mode,
        latency=latency, max_hops=max_hops,
    )
    return tracer._trace_pairs(list(shard))


def auto_processes(num_pairs: int, max_procs: int = 8) -> int:
    """Paper: the process count 'can be automatically calculated based on
    the total number of pairs in the workload'."""
    return max(1, min(max_procs, num_pairs))
