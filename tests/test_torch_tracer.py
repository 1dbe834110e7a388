"""The port's hop-by-hop tracer (the paper's Algorithm 1) and ECMP
policy against the JAX package's, on the CPU, and the vector engine's
bridges to them: ``VectorTraceResult.paths_for_seed`` and
``MonteCarloThroughput.pair_throughput_for_seed``.

Both packages get the same inputs: the fabric through ``to_json`` /
``Fabric.from_json`` and the flows through ``interop.flows_from_records``.
Paths are compared by link name, connection counts exactly, and the
vector bridges against the port's own tracer (paths equal, pair rates
to 1e-9 relative: the scalar model and the fill sum in another order)."""

import pickle
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.flows import PROTO_TCP  # noqa: E402
from repro_torch.interop import flows_from_records  # noqa: E402

CPU = "cpu"
TRACE_SEEDS = [0, 3, 7, 1234567, 2**40 + 17]
FIELD_MODES = [R.FIELDS_5TUPLE, R.FIELDS_VXLAN, R.FIELDS_IP_PAIR]
FABRICS = ["paper", "multipod"]


def port_flows(flows):
    return flows_from_records(
        (f.flow_id, f.src, f.dst, f.tuple5.src_ip, f.tuple5.dst_ip,
         f.tuple5.src_port, f.tuple5.dst_port, f.tuple5.protocol, f.bytes)
        for f in flows)


def port_workload(wl):
    return T.WorkloadDescription(
        pairs=[T.PairSpec(p.src, p.dst, p.num_flows, p.bytes_per_flow)
               for p in wl.pairs],
        filter_protocols=tuple(wl.filter_protocols))


def names(paths):
    return {k: [ln.name for ln in v] for k, v in paths.items()}


@pytest.fixture(scope="module")
def setups(paper_setup, multipod_small):
    """fabric name -> ((reference fabric, workload, flows), (the port's))."""
    out = {}
    for name, (fab, wl, flows) in (("paper", paper_setup),
                                   ("multipod", multipod_small)):
        out[name] = ((fab, wl, flows),
                     (T.Fabric.from_json(fab.to_json()), port_workload(wl),
                      port_flows(flows)))
    return out


def trace_both(setups, fabric, seed, mode=R.FIELDS_5TUPLE, **kw):
    (rf, rwl, rfl), (tf, twl, tfl) = setups[fabric]
    ref = R.FlowTracer(rf, R.EcmpRouting(rf, seed=seed, fields=mode), rwl,
                       rfl, **kw).trace()
    got = T.FlowTracer(tf, T.EcmpRouting(tf, seed=seed, fields=mode), twl,
                       tfl, **kw).trace()
    return ref, got


# ---------------------------------------------------------------------------
# the tracer against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", FIELD_MODES)
@pytest.mark.parametrize("seed", TRACE_SEEDS)
@pytest.mark.parametrize("fabric", FABRICS)
def test_tracer_paths_match_reference(setups, fabric, seed, mode):
    ref, got = trace_both(setups, fabric, seed, mode)
    assert names(got.paths) == names(ref.paths)
    assert [f.flow_id for f in got.flows] == [f.flow_id for f in ref.flows]
    assert len(got.paths) == len(setups[fabric][0][2])


@pytest.mark.parametrize("parallel", [dict(num_threads=1),
                                      dict(num_threads=2),
                                      dict(num_threads=8),
                                      dict(num_processes=2, num_threads=2)])
@pytest.mark.parametrize("fabric", FABRICS)
def test_thread_and_process_counts_do_not_change_paths(setups, fabric,
                                                       parallel):
    ref, _ = trace_both(setups, fabric, 3)
    _, (tf, twl, tfl) = setups[fabric]
    got = T.FlowTracer(tf, T.EcmpRouting(tf, seed=3), twl, tfl,
                       **parallel).trace()
    assert names(got.paths) == names(ref.paths)
    assert got.num_processes == parallel.get("num_processes", 1)
    assert got.num_threads == parallel["num_threads"]


def test_process_pool_after_torch_work_matches_serial(setups):
    """Workers started from a process whose torch thread pool has run
    walk only the fabric's dicts and give the serial paths; the pool
    spawns them, so no threaded process is forked."""
    _, (tf, twl, tfl) = setups["paper"]
    x = torch.randn(512, 512, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(x @ x).all()
    routing = T.EcmpRouting(tf, seed=7)
    serial = T.FlowTracer(tf, routing, twl, tfl).trace()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        par = T.FlowTracer(tf, routing, twl, tfl, num_processes=2,
                           num_threads=2).trace()
    assert names(par.paths) == names(serial.paths)
    assert par.stats.queries == serial.stats.queries


@pytest.mark.parametrize("mode", [T.ADHOC, T.PERSISTENT])
@pytest.mark.parametrize("fabric", FABRICS)
def test_connection_counts_match_reference(setups, fabric, mode):
    ref, got = trace_both(setups, fabric, 3, connection_mode=mode)
    assert (got.stats.connects, got.stats.queries) == (
        ref.stats.connects, ref.stats.queries)
    if mode == T.ADHOC:
        assert got.stats.connects == got.stats.queries
    # many threads: each keeps its own channels, the queries stay the same
    ref8, got8 = trace_both(setups, fabric, 3, connection_mode=mode,
                            num_threads=8)
    assert got8.stats.queries == ref8.stats.queries == got.stats.queries


def test_persistent_reuses_channels(setups):
    _, (tf, twl, tfl) = setups["paper"]
    adhoc, persist = (
        T.FlowTracer(tf, T.EcmpRouting(tf, seed=3), twl, tfl,
                     connection_mode=m).trace() for m in (T.ADHOC,
                                                          T.PERSISTENT))
    assert adhoc.stats.queries == persist.stats.queries
    assert persist.stats.connects < adhoc.stats.connects / 4


def test_persistent_faster_with_latency(setups):
    """Paper Fig. 5: connection setup dominates -> persistent wins."""
    _, (tf, twl, tfl) = setups["paper"]
    small = T.WorkloadDescription(pairs=twl.pairs[:2])
    lat = T.LatencyModel(connect_s=0.003, query_s=0.0)
    t_adhoc, t_persist = (
        T.FlowTracer(tf, T.EcmpRouting(tf, seed=3), small, tfl,
                     connection_mode=m, latency=lat).trace().wall_time_s
        for m in (T.ADHOC, T.PERSISTENT))
    assert t_persist < t_adhoc


@pytest.mark.parametrize("protocols", [None, (PROTO_TCP,)])
@pytest.mark.parametrize("fabric", FABRICS)
def test_workload_filter_matches_reference(setups, fabric, protocols):
    (rf, rwl, rfl), (tf, twl, tfl) = setups[fabric]
    kw = {} if protocols is None else {"filter_protocols": protocols}
    ref = R.FlowTracer(rf, R.EcmpRouting(rf, seed=3),
                       R.WorkloadDescription(pairs=[rwl.pairs[0]], **kw),
                       rfl).trace()
    got = T.FlowTracer(tf, T.EcmpRouting(tf, seed=3),
                       T.WorkloadDescription(pairs=[twl.pairs[0]], **kw),
                       tfl).trace()
    assert names(got.paths) == names(ref.paths)
    # the synthesized flows are UDP: a TCP-only filter traces none
    assert len(got.paths) == (0 if protocols else twl.pairs[0].num_flows)


@pytest.mark.parametrize("n_pairs", [1, 2, 5, 8, 9, 40, 128])
def test_auto_processes_matches_reference(n_pairs):
    assert T.auto_processes(n_pairs) == R.auto_processes(n_pairs)
    assert T.auto_processes(n_pairs, 4) == R.auto_processes(n_pairs, 4)
    assert 1 <= T.auto_processes(n_pairs) <= min(8, n_pairs)


def _wrong_destination(pkg, fab, flows):
    """A flow whose recorded destination is not the server behind its
    destination ip."""
    f = flows[0]
    other = next(g.dst for g in flows if g.dst != f.dst)
    bad = pkg.Flow(flow_id=f.flow_id, src=f.src, dst=other, tuple5=f.tuple5)
    return pkg.FlowTracer(
        fab, pkg.EcmpRouting(fab, seed=3),
        pkg.WorkloadDescription(pairs=[pkg.PairSpec(f.src, other, 1)]), [bad])


@pytest.mark.parametrize("case", ["wrong_destination", "max_hops"])
def test_runtime_errors_match_reference(setups, case):
    messages = []
    for pkg, (fab, wl, flows) in zip((R, T), setups["paper"]):
        if case == "wrong_destination":
            tracer = _wrong_destination(pkg, fab, flows)
        else:
            tracer = pkg.FlowTracer(fab, pkg.EcmpRouting(fab, seed=3), wl,
                                    flows, max_hops=2)
        with pytest.raises(RuntimeError) as err:
            tracer.trace()
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert ("terminated at" if case == "wrong_destination"
            else "exceeded 2 hops") in messages[1]


def test_fabric_flows_and_policies_pickle(setups):
    """What the process pool sends its workers."""
    _, (tf, twl, tfl) = setups["multipod"]
    table, _ = T.static_route_assignment(tf, tfl)
    for routing in (T.EcmpRouting(tf, seed=5, fields=T.FIELDS_VXLAN),
                    T.StaticRouting(tf, table)):
        fab2, routing2, wl2, flows2 = pickle.loads(
            pickle.dumps((tf, routing, twl, tfl)))
        assert flows2 == tfl and wl2.pairs == twl.pairs
        assert [ln.name for ln in fab2.links] == [ln.name for ln in tf.links]
        a = T.FlowTracer(tf, routing, twl, tfl).trace()
        b = T.FlowTracer(fab2, routing2, wl2, flows2).trace()
        assert names(a.paths) == names(b.paths)


def test_device_seed_matches_reference():
    for dev in ("leaf-0", "spine-3", "srv-12", "host-100"):
        for seed in TRACE_SEEDS:
            assert T.device_seed(dev, seed) == R.device_seed(dev, seed)


# ---------------------------------------------------------------------------
# the vector engine's bridges, against the port's tracer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", FIELD_MODES)
@pytest.mark.parametrize("fabric", FABRICS)
def test_paths_for_seed_equals_the_tracer(setups, fabric, mode):
    (rf, _, rfl), (tf, twl, tfl) = setups[fabric]
    res = T.simulate_paths(T.compile_fabric(tf), tfl, TRACE_SEEDS,
                           fields=mode, hash_backend="exact", device=CPU)
    ref = R.simulate_paths(R.compile_fabric(rf), rfl, TRACE_SEEDS,
                           fields=mode, hash_backend="exact")
    assert res.num_seeds == len(TRACE_SEEDS)
    for i, seed in enumerate(TRACE_SEEDS):
        traced = T.FlowTracer(tf, T.EcmpRouting(tf, seed=seed, fields=mode),
                              twl, tfl).trace()
        got = names(res.paths_for_seed(i))
        assert got == names(traced.paths)
        assert got == names(ref.paths_for_seed(i))


def test_murmur_paths_differ_from_the_tracer(setups):
    """The tracer hashes with ``ecmp_hash``: only ``exact`` walks match it,
    so tracer-parity callers must pass ``hash_backend="exact"``."""
    _, (tf, twl, tfl) = setups["paper"]
    comp = T.compile_fabric(tf)
    traced = names(T.FlowTracer(tf, T.EcmpRouting(tf, seed=7), twl,
                                tfl).trace().paths)
    murmur = names(T.simulate_paths(comp, tfl, [7], hash_backend="murmur",
                                    device=CPU).paths_for_seed(0))
    assert set(murmur) == set(traced)
    differ = sum(murmur[k] != traced[k] for k in traced)
    assert differ > len(traced) // 2, differ


def test_paths_for_seed_raises_on_a_sprayed_result(setups):
    (rf, _, rfl), (tf, _, tfl) = setups["paper"]
    got = T.simulate_paths(T.compile_fabric(tf), tfl, [0, 1],
                           strategy="prime-spray", device=CPU)
    ref = R.simulate_paths(R.compile_fabric(rf), rfl, [0, 1],
                           strategy="prime-spray")
    with pytest.raises(ValueError) as want:
        ref.paths_for_seed(0)
    with pytest.raises(ValueError, match="use flowlet_paths_for_seed") as err:
        got.paths_for_seed(0)
    assert str(err.value) == str(want.value)


@pytest.mark.parametrize("fabric", FABRICS)
def test_pair_throughput_for_seed_equals_the_scalar_model(setups, fabric):
    (rf, _, rfl), (tf, twl, tfl) = setups[fabric]
    seeds = [7, 11, 42]
    mc = T.monte_carlo_throughput(tf, tfl, seeds, hash_backend="exact",
                                  device=CPU)
    ref = R.monte_carlo_throughput(rf, rfl, seeds, hash_backend="exact")
    assert mc.num_seeds == ref.num_seeds == len(seeds)
    for i, seed in enumerate(seeds):
        traced = T.FlowTracer(tf, T.EcmpRouting(tf, seed=seed), twl,
                              tfl).trace()
        scalar = T.per_pair_throughput(tfl, traced.paths)
        got = mc.pair_throughput_for_seed(i)
        want = ref.pair_throughput_for_seed(i)
        assert list(got) == list(want) and set(got) == set(scalar)
        assert all(isinstance(v, float) for v in got.values())
        for pair, rate in scalar.items():
            assert got[pair] == pytest.approx(rate, rel=1e-9, abs=0)
            assert got[pair] == pytest.approx(want[pair], rel=1e-9, abs=0)
    np.testing.assert_array_equal(
        [mc.pair_throughput_for_seed(j)[mc.pairs[0]] for j in range(3)],
        mc.per_pair[0].numpy())
