"""The port on the card against the port on the CPU.

Every test here needs a CUDA card and skips (from inside the test) on a
host without one.  They import neither ``jax`` nor the JAX package's
kernels, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CPU side is held against the JAX package by the other
``test_torch_*`` files; here the card must give the same link ids bit
for bit, counts and FIM to 1e-12 and rates to 1e-9 relative (float
atomics on the card sum in another order).  Every routing strategy
routes the same seed list on both sides (the wave couples its seeds)
under unit demand, and the byte-weighted ones under byte demand too
(every load sum takes the ordered-sum kernel): the same link ids and
flowlet layout, FIM to 1e-12, rates and goodput to 1e-9 and exposure
to 1e-12 absolute.  The ordered sum must equal ``torch.bincount`` on the
CPU bit for bit, and the sequential placement kernel its plain version
(link ids, float64 loads, hop count and the fault it reports), in both
of its instances.  The flash-attention kernel
must match its plain version to 2e-6 in f32 and 2e-2 in bf16 (the JAX
package's tolerances for its Pallas kernel) and, row by row, to the
relative limits of ``ref.ROW_RTOL`` (1e-4 f32, 2e-2 bf16); the SSD
kernel to 1e-5 in f32 and 5e-2 in bf16 (the JAX package's tolerances for
its SSD kernel) and to its own row limits (``ref.ROW_RTOL`` and
``ref.STATE_ROW_RTOL``);
the reduced granite and mamba2 models on the card must match the CPU in
f32 with TF32 off.  The bridges to the hop-by-hop tracer must hold on the
card: ``paths_for_seed`` of an ``exact`` walk equals the CPU's and the
tracer's paths, ``pair_throughput_for_seed`` the CPU's to 1e-9, and the
tracer's process pool, started after the card's work, the serial trace.
The departure-ordered drain (its kernel, a cluster of CTAs per seed
over dense cell lists, against its plain version at every cluster size
and at edge shapes) and the event-timed timeline must give the CPU's
completion times, step durations and job completion time to 1e-9 (and
every step's link ids bit for bit) on the same seed list.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _scan_faults import BWD_FAULTS as SCAN_BWD_FAULTS  # noqa: E402
from _scan_faults import BWD_READ_FAULT  # noqa: E402
from _scan_faults import FAULTS as SCAN_FAULTS  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core import vector_sim as TV  # noqa: E402
from repro_torch.core import vector_throughput as TT  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flowhash import ops, ref  # noqa: E402
from repro_torch.kernels.loads import build as loads_build  # noqa: E402
from repro_torch.kernels.loads import ops as loads_ops  # noqa: E402
from repro_torch.kernels.loads import ref as loads_ref  # noqa: E402
from repro_torch.kernels.placement import build as pl_build  # noqa: E402
from repro_torch.kernels.placement import ops as pl_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu

SEEDS = [0, 7, 2**40 + 17, 2**63, 2**64 - 1] + list(range(100, 159))


FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the f32 plain versions and the f32 model are compared in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def multipod():
    fab = T.build_multipod_fabric(num_pods=2, hosts_per_pod=8,
                                  leaves_per_pod=2, num_spines=4)
    wl = T.bipartite_pairs([f"host-{i}" for i in range(8)],
                           [f"host-{8 + i}" for i in range(8)],
                           flows_per_pair=4,
                           bytes_per_flow=[1, 5, 10, 2**20, 0, 3, 9, 2**30])
    flows = T.synthesize_flows(wl, nic_ip=T.nic_ip, nics_per_server=1)
    return T.compile_fabric(fab), flows


@pytest.fixture(scope="module")
def multipod3():
    """Three default pods: compact tables too large for shared memory
    beside the load rows, so the placement kernel reads them from global
    memory.  64 flows between pods 0 and 2."""
    wl = T.bipartite_pairs([f"host-{i}" for i in range(8)],
                           [f"host-{128 + i}" for i in range(8)],
                           flows_per_pair=4)
    flows = T.synthesize_flows(wl, nic_ip=T.nic_ip, nics_per_server=1)
    return T.compile_fabric(T.build_multipod_fabric(num_pods=3)), flows


def test_kernel_matches_plain_version(card):
    rng = np.random.default_rng(1)
    f = torch.from_numpy(rng.integers(0, 2**40, (3000, 5))).to(card)
    sd = torch.from_numpy(rng.integers(0, 2**62, (3000, 257))).to(card)
    ops.reset_launches()
    got = ops.murmur_hash_grid(f, sd)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.murmur_hash_grid_ref(f, sd))
    init = torch.full_like(sd[:, :1], 5)
    assert torch.equal(ops.bulk_hash(f, 2**33 + 5),
                       ref.murmur_hash_grid_ref(f, init)[:, 0])
    assert ops.LAUNCHES == {"murmur_hash_grid": 1, "bulk_hash": 1}


WRAP_SEEDS = [2**31, 2**32 - 1, 2**32 + 5, 2**40 + 7, -1, -2**31 - 3]


@pytest.mark.parametrize("seed", WRAP_SEEDS)
def test_bulk_hash_seed_wraps_like_the_cpu_path(card, seed):
    """Seeds at and past 2**31, and negative ones, hash from their low 32
    bits on the card as on the CPU path (which the CPU tests hold against
    the JAX package's ``bulk_hash``)."""
    rng = np.random.default_rng(4)
    f = torch.from_numpy(rng.integers(0, 2**32, (777, 5)))
    ops.reset_launches()
    got = ops.bulk_hash(f.to(card), seed)
    assert ops.LAUNCHES["bulk_hash"] == 1
    assert torch.equal(got.cpu(), ops.bulk_hash(f, seed))


def test_bulk_hash_never_synchronises(card):
    """``bulk_hash`` and ``simulate_paper_paths`` (four launches) copy
    nothing to the card and never wait on it: under the sync debug mode
    "error" a synchronising call would raise."""
    rng = np.random.default_rng(42)
    f = torch.from_numpy(rng.integers(0, 2**31, (4096, 5))).to(card)
    ops.bulk_hash(f, 1)                     # build and load outside the mode
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = ops.bulk_hash(f, 12345)
        stages = ops.simulate_paper_paths(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.LAUNCHES == {"murmur_hash_grid": 0, "bulk_hash": 5}
    assert h[:4].tolist() == [1282828036, 453300701, 462728589, 1920719609]
    assert int(stages["uplink"].sum()) == 30992


def test_kernel_wrapper_raises_instead_of_falling_back(card):
    f = torch.zeros((4, 5), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        ops.murmur_hash_grid(f, torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.murmur_hash_grid(
            f, torch.zeros((3, 4), dtype=torch.int64, device=card).T)


@pytest.mark.parametrize("backend", ["exact", "murmur"])
def test_walk_on_card_equals_cpu(card, multipod, backend):
    comp, flows = multipod
    for mode in ("5tuple", "vxlan", "ip-pair"):
        want = T.simulate_paths(comp, flows, SEEDS, fields=mode,
                                hash_backend=backend, device="cpu")
        got = T.simulate_paths(comp, flows, SEEDS, fields=mode,
                               hash_backend=backend)
        assert got.link_ids.device.type == "cuda"
        assert torch.equal(got.link_ids.cpu(), want.link_ids), mode


@pytest.mark.parametrize("demand", ["uniform", "bytes"])
def test_fim_and_rates_on_card_equal_cpu(card, multipod, demand,
                                        monkeypatch):
    comp, flows = multipod
    kw = dict(hash_backend="exact", demand_mode=demand)
    want = T.monte_carlo_fim(comp, flows, SEEDS, only_used_leaves=True,
                             device="cpu", **kw)
    got = T.monte_carlo_fim(comp, flows, SEEDS, only_used_leaves=True, **kw)
    np.testing.assert_allclose(got.aggregate.cpu().numpy(),
                               want.aggregate.numpy(), rtol=1e-12, atol=0)
    want = T.monte_carlo_throughput(comp, flows, SEEDS, device="cpu", **kw)
    monkeypatch.setattr(TT, "seed_chunk_size", lambda *a: 9)  # 8 chunks
    got = T.monte_carlo_throughput(comp, flows, SEEDS, **kw)
    assert got.seed_chunk == 9
    np.testing.assert_allclose(got.rates.cpu().numpy(), want.rates.numpy(),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.per_pair.cpu().numpy(),
                               want.per_pair.numpy(), rtol=1e-9, atol=0)


def _names(paths):
    return {k: [ln.name for ln in v] for k, v in paths.items()}


@pytest.mark.parametrize("mode", ["5tuple", "vxlan", "ip-pair"])
def test_paths_for_seed_on_card_equal_cpu_and_the_tracer(card, multipod,
                                                          mode):
    comp, flows = multipod
    seeds = [0, 7, 1234567, 2**40 + 17]
    got = T.simulate_paths(comp, flows, seeds, fields=mode,
                           hash_backend="exact")
    want = T.simulate_paths(comp, flows, seeds, fields=mode,
                            hash_backend="exact", device="cpu")
    assert got.link_ids.device.type == "cuda"
    wl = T.workload_from_flows(flows)
    for i, seed in enumerate(seeds):
        paths = _names(got.paths_for_seed(i))
        assert paths == _names(want.paths_for_seed(i))
        traced = T.FlowTracer(comp.fabric, T.EcmpRouting(
            comp.fabric, seed=seed, fields=mode), wl, flows).trace()
        assert paths == _names(traced.paths)


def test_pair_throughput_for_seed_on_card_equals_cpu(card, multipod):
    comp, flows = multipod
    seeds = [7, 11, 42]
    got = T.monte_carlo_throughput(comp, flows, seeds, hash_backend="exact")
    want = T.monte_carlo_throughput(comp, flows, seeds, hash_backend="exact",
                                    device="cpu")
    assert got.per_pair.device.type == "cuda" and got.num_seeds == 3
    for i in range(3):
        a, b = got.pair_throughput_for_seed(i), want.pair_throughput_for_seed(i)
        assert list(a) == list(b)
        for pair, rate in b.items():
            assert a[pair] == pytest.approx(rate, rel=1e-9, abs=0)


def test_process_trace_after_card_work_equals_serial(card, multipod):
    """The tracer's process pool, started from a process that holds a
    CUDA context, gives the serial paths."""
    comp, flows = multipod
    res = T.simulate_paths(comp, flows, [7], hash_backend="exact")
    torch.cuda.synchronize()
    wl = T.workload_from_flows(flows)
    routing = T.EcmpRouting(comp.fabric, seed=7)
    serial = T.FlowTracer(comp.fabric, routing, wl, flows).trace()
    par = T.FlowTracer(comp.fabric, routing, wl, flows, num_processes=4,
                       num_threads=4).trace()
    assert _names(par.paths) == _names(serial.paths)
    assert _names(par.paths) == _names(res.paths_for_seed(0))


#: every registered strategy, and the wave forced onto its own path
#: (the fixture's 64 flows on 192 links are below its cutover) with and
#: without the round cap's residue fallback
STRATEGY_CASES = {
    **{name: (lambda name=name: T.resolve_strategy(name))
       for name in T.available_strategies()},
    "wave-path": lambda: T.WaveCongestionAware(min_wave_load=0.0),
    "wave-residue": lambda: T.WaveCongestionAware(max_rounds=1,
                                                  min_wave_load=0.0),
}


#: the cases routed again under byte demand (the fixture's flows carry
#: 1 B to 1 GiB): the adaptive ones sum their loads with the ordered-sum
#: kernel, where the order of the adds decides paths; the wave's
#: heterogeneous weights take the sequential chain
BYTE_DEMAND_CASES = ["adaptive-spray", "adaptive-spray-elephant",
                     "prime-spray-elephant", "congestion-aware", "wave-path"]


@pytest.mark.parametrize("case", sorted(STRATEGY_CASES) + [
    f"{name}:bytes" for name in BYTE_DEMAND_CASES])
def test_strategy_on_card_equals_cpu(card, multipod, case, monkeypatch):
    comp, flows = multipod
    name, _, demand = case.partition(":")
    make = STRATEGY_CASES[name]
    kw = dict(hash_backend="murmur", demand_mode=demand or "uniform")
    want = T.simulate_paths(comp, flows, SEEDS, strategy=make(),
                            device="cpu", **kw)
    sums, real = [], TS._cell_loads

    def counted(*args):
        sums.append(1)
        return real(*args)

    monkeypatch.setattr(TS, "_cell_loads", counted)
    loads_ops.reset_launches()
    got = T.simulate_paths(comp, flows, SEEDS, strategy=make(), **kw)
    ordered = loads_ops.LAUNCHES["ordered_cell_sum"]
    # every load sum is one launch of the ordered kernel, and the
    # byte-demand adaptive rounds sum loads
    assert ordered == len(sums), (ordered, len(sums))
    assert ordered > 0 or not (demand == "bytes"
                               and name.startswith("adaptive")), ordered
    assert got.link_ids.device.type == "cuda"
    assert torch.equal(got.link_ids.cpu(), want.link_ids)
    assert torch.equal(got.flow_index.cpu(), want.flow_index)
    assert torch.equal(got.demand.cpu(), want.demand)
    assert (got.extra_exposure is None) == (want.extra_exposure is None)
    if want.extra_exposure is not None:
        np.testing.assert_allclose(got.extra_exposure.cpu().numpy(),
                                   want.extra_exposure.numpy(),
                                   rtol=1e-12, atol=0)
    np.testing.assert_allclose(T.fim_vector(got).cpu().numpy(),
                               T.fim_vector(want).numpy(), rtol=1e-12, atol=0)
    a = T.throughput_from_result(want, transport="roce-nack")
    b = T.throughput_from_result(got, transport="roce-nack")
    for field in ("rates", "goodput", "per_pair"):
        np.testing.assert_allclose(getattr(b, field).cpu().numpy(),
                                   getattr(a, field).numpy(),
                                   rtol=1e-9, atol=0, err_msg=field)
    np.testing.assert_allclose(b.exposure.cpu().numpy(), a.exposure.numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("trial", range(4))
def test_departure_fill_on_card_equals_cpu(card, trial):
    """Seeded random link ids with repeats, -1 padding, zero-gigabit and
    linkless columns, weights, efficiency and reused initial rates: the
    card's drain within 1e-9 of the CPU's (float atomics in the fill
    sum in another order; drain rounds may differ and are not held)."""
    rng = np.random.default_rng(2000 + trial)
    H, N, S, L = 4, 600, 16, 40
    ids = torch.from_numpy(rng.integers(-1, L, size=(H, N, S)))
    gb = rng.uniform(0.5, 20.0, size=N)
    gb[rng.random(N) < 0.1 * (trial % 2)] = 0.0
    cap = rng.uniform(50.0, 200.0, size=L)
    w = rng.uniform(0.2, 3.0, size=N) if trial % 2 else None
    eff = rng.uniform(0.3, 1.0, size=(N, S))
    init = T.batched_max_min(ids, cap, weights=w) if trial == 2 else None
    kw = dict(weights=w, efficiency=eff, initial_rates=init)
    want = T.departure_fill(ids, cap, gb, device="cpu", **kw)
    got = T.departure_fill(ids, cap, gb, **kw)
    assert got.completion.device.type == "cuda"
    np.testing.assert_allclose(got.completion.cpu().numpy(),
                               want.completion.numpy(), rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.duration.cpu().numpy(),
                               want.duration.numpy(), rtol=1e-9, atol=0)
    two = T.departure_fill(torch.zeros((1, 2, 3), dtype=torch.int64,
                                       device=card), [100.0], [8.0, 24.0])
    np.testing.assert_allclose(two.completion.cpu().numpy(),
                               [[0.16] * 3, [0.32] * 3], rtol=1e-12)


def _drain_inputs(rng, H=4, N=900, S=12, L=48, weighted=True):
    """The drain's live cells of a random (H, N, S) link tensor, as
    ``departure_fill`` hands them over: seed-major cell ids, seeds,
    gigabits, efficiency and weights."""
    ids = torch.from_numpy(rng.integers(-1, L, size=(H, N, S)))
    ids = TT.dedup_link_ids(ids)
    cells = ids.transpose(1, 2).reshape(H, S * N)
    seed = torch.arange(S).repeat_interleave(N)
    cells = torch.where(cells >= 0, cells + seed * L, S * L)
    col = torch.arange(N).repeat(S)
    gb = torch.from_numpy(rng.uniform(0.5, 20.0, size=N))[col]
    eff = torch.from_numpy(rng.uniform(0.3, 1.0, size=S * N))
    w = (torch.from_numpy(rng.uniform(0.2, 3.0, size=N))[col]
         if weighted else None)
    cap = torch.from_numpy(rng.uniform(50.0, 200.0, size=L))
    return cells, seed, S, cap, gb, eff, w


@pytest.mark.parametrize("weighted", [True, False])
def test_departure_drain_kernel_matches_plain_version(card, weighted):
    """The kernel (a block per seed) against the plain version on the
    same cells: completion within 1e-9 (shared-memory atomics sum in
    another order), one launch.  Drain rounds are not compared: the
    atomics may move a finish time across a departure horizon."""
    from repro_torch.kernels.drain import ops as drain_ops
    args = _drain_inputs(np.random.default_rng(7), weighted=weighted)
    cells, seed, S, cap, gb, eff, w = args
    want = drain_ops.departure_drain(*args, None, 10_000)
    drain_ops.reset_launches()
    got = drain_ops.departure_drain(
        cells.to(card), seed.to(card), S, cap.to(card), gb.to(card),
        eff.to(card), None if w is None else w.to(card), None, 10_000)
    assert drain_ops.LAUNCHES == {"departure_drain": 1}
    assert got.done.device.type == "cuda" and got.flops > 0
    np.testing.assert_allclose(got.done.cpu().numpy(), want.done.numpy(),
                               rtol=1e-9, atol=0)
    assert 0 < got.rounds <= cells.shape[1]


def _drain_case(rng, H=4, N=900, S=12, L=48, weighted=True, init=False,
                empty_seed=False, linkless=0.0, uniform=None):
    """``_drain_inputs`` with a seed left with no cell, a share of
    columns that cross no link, round-1 rates and one weight for every
    cell, as asked; returns the drain's arguments up to ``max_rounds``."""
    cells, seed, S, cap, gb, eff, w = _drain_inputs(rng, H, N, S, L, weighted)
    if uniform is not None:
        w = torch.full_like(gb, uniform)
    if linkless:
        cells[:, torch.from_numpy(rng.random(N) < linkless).repeat(S)] = S * L
    if empty_seed:
        keep = seed != S // 2
        cells, seed, gb, eff = cells[:, keep], seed[keep], gb[keep], eff[keep]
        w = None if w is None else w[keep]
    ini = (torch.from_numpy(rng.uniform(1.0, 30.0, size=seed.numel()))
           if init else None)
    return cells, seed, S, cap, gb, eff, w, ini


def _drain_on_card(card, args, want, cluster=None):
    """The kernel on ``args`` (moved to the card) against the plain
    version's ``want``: completion within 1e-9, one launch."""
    from repro_torch.kernels.drain import ops as drain_ops
    dargs = [a.to(card) if isinstance(a, torch.Tensor) else a for a in args]
    drain_ops.reset_launches()
    got = drain_ops.departure_drain(*dargs, 10_000, cluster=cluster)
    assert drain_ops.LAUNCHES == {"departure_drain": 1}
    np.testing.assert_allclose(got.done.cpu().numpy(), want.done.numpy(),
                               rtol=1e-9, atol=0)
    return got


@pytest.fixture(scope="module")
def long_seed():
    """One seed of 2,600 cells, more than a CTA has threads and more
    than one 2,048-cell tile of its passes, and the plain version's
    drain of it."""
    from repro_torch.kernels.drain import ops as drain_ops
    args = _drain_case(np.random.default_rng(11), N=2_600, S=1)
    return args, drain_ops.departure_drain(*args, 10_000)


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
def test_departure_drain_spreads_a_seed_over_a_cluster(card, long_seed,
                                                       cluster):
    """The seed's cells split over 1 to 8 CTAs (``None``: the plan's),
    which share shares, stamps, counts and the horizon through
    distributed shared memory: the plain version's completion times,
    and the same operations counted whatever the cluster."""
    args, want = long_seed
    got = _drain_on_card(card, args, want, cluster)
    assert got.flops > 0 and got.chain >= got.rounds + got.fill_rounds


@pytest.mark.parametrize("case", [
    dict(N=300, S=200, L=24),                    # more seeds than SMs
    dict(N=600, S=5, L=40, init=True, empty_seed=True, linkless=0.1),
    dict(N=900, S=12, weighted=False, init=True),
    dict(H=6, N=700, S=4, L=30),                 # two 4-hop loads a cell
    dict(N=900, S=6, uniform=0.125),             # counted: 0.125 x members
    dict(N=900, S=6, uniform=0.3),               # summed in L2
], ids=["200-seeds", "empty-seed-linkless-init", "unweighted-init",
        "six-hops", "uniform-power-of-two", "uniform-other"])
@pytest.mark.parametrize("cluster", [None, 2])
def test_departure_drain_edge_shapes_on_the_card(card, case, cluster):
    """Edge shapes at the plan's cluster and at a cluster of 2: a seed
    with no cell, columns that cross no link (an infinite rate), round-1
    rates, unit demand, more seeds than the card has SMs, six hops, and
    one weight for every cell (a power of two: member counts; another:
    weight sums)."""
    from repro_torch.kernels.drain import ops as drain_ops
    args = _drain_case(np.random.default_rng(12), **case)
    _drain_on_card(card, args, drain_ops.departure_drain(*args, 10_000),
                   cluster)


def test_departure_drain_at_max_links(card):
    """A fabric at ``max_links()``: the link rows fill a CTA's shared
    memory and the plan spreads the seed's lists over a cluster."""
    from repro_torch.kernels.drain import ops as drain_ops
    L = drain_ops.max_links()
    args = _drain_case(np.random.default_rng(13), N=900, S=2, L=L,
                       weighted=False)
    assert drain_ops.plan(2, 900, L, 4).cluster > 1
    _drain_on_card(card, args, drain_ops.departure_drain(*args, 10_000))


def test_departure_drain_refused_shape_raises_on_the_card(card, monkeypatch):
    """Nine hops a cell: the plan refuses, naming its limit, and the
    wrapper raises rather than take the plain version."""
    from repro_torch.kernels.drain import ops as drain_ops
    monkeypatch.setattr(drain_ops, "departure_drain_ref", None)
    args = _drain_case(np.random.default_rng(14), H=9, N=50, S=2, L=30)
    dargs = [a.to(card) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="at most 8"):
        drain_ops.departure_drain(*dargs, 10_000)


def test_drain_sync_probe_times_a_reduction(card):
    """The cluster-reduction probe behind the latency bound runs at the
    plan's launch shape and gives a positive, sub-millisecond cost."""
    from repro_torch.kernels.drain import ops as drain_ops
    for c in (1, 2):
        pl = drain_ops.plan(64, 4_096, 1_024, 4, cluster=c)
        assert 0 < drain_ops.sync_probe_ms(pl, 64, 1_024, 2_000) < 1.0


def test_departure_drain_faults_raise_on_the_card(card, monkeypatch):
    """A zero-capacity link raises the reference's zero-goodput error,
    and the wrapper never falls back to the plain version."""
    from repro_torch.kernels.drain import ops as drain_ops
    monkeypatch.setattr(drain_ops, "departure_drain_ref", None)
    ids = torch.zeros((1, 2, 1), dtype=torch.int64, device=card)
    dep = T.departure_fill(ids, [100.0], [8.0, 24.0])
    np.testing.assert_allclose(dep.completion[:, 0].cpu().numpy(),
                               [0.16, 0.32], rtol=1e-12)
    with pytest.raises(RuntimeError, match="zero goodput"):
        T.departure_fill(ids, [0.0], [1.0, 1.0])


@pytest.fixture(scope="module")
def llm_multipod():
    """The 16-host multipod LLM job (five sequential steps) on the
    default multipod fabric."""
    _, flows, _, sched = T.multipod_llm_schedule(param_bytes=20_000_000_000)
    return T.compile_fabric(T.build_multipod_fabric()), flows, sched


@pytest.mark.parametrize("strategy", ["ecmp", "prime-spray",
                                      "adaptive-spray",
                                      "wave-congestion-aware"])
def test_timeline_on_card_equals_cpu(card, llm_multipod, strategy):
    """Event timing over the same seed list on both sides: every step's
    link ids identical, FIM to 1e-12, rates, goodput, completion times,
    step durations and job completion time to 1e-9."""
    comp, flows, sched = llm_multipod
    seeds = list(range(6))
    spec = dict(strategy=strategy, demand_mode="bytes",
                transport="roce-nack", hash_backend="murmur",
                timing="event")
    want = T.simulate_timeline(comp, flows, sched, seeds, device="cpu",
                               **spec)
    got = T.simulate_timeline(comp, flows, sched, seeds, **spec)
    assert got.job_completion.device.type == "cuda"
    for g, w in zip(got.steps, want.steps):
        np.testing.assert_allclose(g.fim.aggregate.cpu().numpy(),
                                   w.fim.aggregate.numpy(), rtol=1e-12,
                                   atol=0)
        for field in ("rates", "goodput"):
            np.testing.assert_allclose(
                getattr(g.throughput, field).cpu().numpy(),
                getattr(w.throughput, field).numpy(), rtol=1e-9, atol=0)
        np.testing.assert_allclose(g.completion.cpu().numpy(),
                                   w.completion.numpy(), rtol=1e-9, atol=0)
    for name in ("step_durations", "job_completion", "fim", "goodput"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(want, name).numpy(), rtol=1e-9,
                                   atol=0, err_msg=name)
    route = dict(strategy=strategy, demand_mode="bytes",
                 hash_backend="murmur")
    for sub in T.partition_flows(flows, sched):
        a = T.simulate_paths(comp, sub, seeds, device="cpu", **route)
        b = T.simulate_paths(comp, sub, seeds, **route)
        assert torch.equal(b.link_ids.cpu(), a.link_ids)


MAX_HOPS = 16


def placement_case(comp, flows, fm, n_seeds, weights, masked, preload,
                   rng):
    """Inputs of one chain as host arrays: uint64 seeds, per-flow
    weights, placement order, (S, L) committed loads, an (N, S) mask or
    None, and the (H, N, S) link ids to fill."""
    n, L = len(flows), comp.num_links
    seeds = rng.integers(0, 2**64, n_seeds, dtype=np.uint64)
    w = (np.ones(n) if weights == "unit"
         else rng.random(n) * 3.0 + 0.1)
    order = np.argsort(-w, kind="stable")
    load = (rng.integers(0, 5, (n_seeds, L)).astype(np.float64) * 0.3
            if preload else np.zeros((n_seeds, L)))
    mask = rng.random((n, n_seeds)) < 0.4 if masked else None
    ids = np.full((MAX_HOPS, n, n_seeds), -1, np.int32)
    return fm, seeds, w, order, load, mask, ids


def port_place(comp, flows, case, backend, device="cpu", max_hops=MAX_HOPS):
    """Run the port's wrapper on ``case``; returns (hops, fault, link ids,
    load) on ``device``."""
    fm, seeds, w, order, load, mask, ids = case
    tabs = comp.to(device)
    ends = [torch.from_numpy(np.asarray(e, np.int64)).to(device)
            for e in comp.flow_endpoint_ids(flows)]
    ids_t = torch.from_numpy(ids.copy()).to(device)
    load_t = torch.from_numpy(load.copy()).to(device)
    hops, fault = pl_ops.congestion_place(
        tabs.cand, tabs.cand_n, tabs.dev_crc, tabs.is_server, tabs.link_dst,
        torch.from_numpy(fm.view(np.int64).copy()).to(device),
        torch.from_numpy(seeds.view(np.int64).copy()).to(device), *ends,
        torch.from_numpy(w).to(device), torch.from_numpy(order).to(device),
        load_t, ids_t,
        None if mask is None else torch.from_numpy(mask).to(device),
        num_keys=tabs.num_keys, c_max=tabs.c_max, max_hops=max_hops,
        murmur=backend == "murmur")
    return hops, fault, ids_t, load_t

def placement_plan(comp):
    tabs = comp.to("cpu")
    _, offs = pl_ops.pack_tables(tabs.cand, tabs.cand_n, tabs.dev_crc,
                                 tabs.is_server, tabs.link_dst, tabs.c_max)
    return pl_ops.plan(comp.num_links, comp.num_devices, tabs.cand_n.numel(),
                       offs["n_cands"])


@pytest.mark.parametrize("backend", ["exact", "murmur"])
@pytest.mark.parametrize("weights", ["unit", "random"])
@pytest.mark.parametrize("masked,preload", [(False, False), (True, True)])
@pytest.mark.parametrize("instance", ["shared", "global"])
def test_placement_kernel_matches_plain_version(card, multipod, multipod3,
                                                backend, weights, masked,
                                                preload, instance):
    """The chain's kernel (a warp per seed) against its plain version on
    the same inputs: link ids, the float64 load tally and the hop count
    bit for bit, for any weights (each seed sums in flow order), with
    the tables in shared memory and, on three pods, in global memory."""
    comp, flows = multipod if instance == "shared" else multipod3
    assert placement_plan(comp).shared_tables == (instance == "shared")
    case = placement_case(comp, flows, T.flow_fields_matrix(flows, "5tuple"),
                          37, weights, masked, preload,
                          np.random.default_rng(5))
    want = port_place(comp, flows, case, backend)
    pl_ops.reset_launches()
    got = port_place(comp, flows, case, backend, device=card)
    assert pl_ops.LAUNCHES == {"congestion_place": 1}
    assert got[:2] == want[:2] and want[1] is None
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[3].cpu(), want[3])


#: the ordered sum's card cases, (H, N, S, L, what the cells hold): the
#: CPU tests' edge shapes at sizes that take several 4,096-row tiles, and
#: the strategies' width.  Seed counts that are multiples of 4 from 8 on
#: bring the rows by TMA (8, 12, 16, 64), the others by cp.async; N up to
#: 4,096 keeps the weights resident, larger N streams them, and 5,000,
#: 9,000 and 50,000 rows a hop wrap to w[0] inside a 256-row box;
#: "unaligned" starts both tensors 4 and 8 bytes past 16
ORDERED_CASES = {
    "bin split across tiles": (3, 5_000, 8, 4, "random"),
    "every cell in one link": (2, 3_000, 5, 7, "one link"),
    "-1 and out-of-range cells": (3, 2_000, 12, 6, "sparse"),
    "one seed": (4, 9_000, 1, 9, "random"),
    "seeds not a multiple of 8": (2, 3_000, 11, 50, "random"),
    "links over several blocks": (2, 4_000, 16, 3_000, "random"),
    "links just past one block": (2, 3_000, 8, 1_025, "random"),
    "unaligned": (2, 6_000, 8, 33, "offset"),
    "wide": (4, 50_000, 64, 1_024, "random"),
}


@pytest.mark.parametrize("case", sorted(ORDERED_CASES))
def test_ordered_cell_sum_matches_plain_version(card, case):
    """Log-normal weights: the kernel's (S, L) sums are ``torch.bincount``'s
    on the CPU bit for bit, the same on every run, with each seed's links
    whole or, past 1,024, split over clusters (``loads_ops.plan``); cells
    outside [0, L) are left out."""
    H, N, S, L, kind = ORDERED_CASES[case]
    rng = np.random.default_rng(H * N + S)
    ids = rng.integers(0, L, (H, N, S)).astype(np.int32)
    if kind == "one link":
        ids[:] = 3
    elif kind == "sparse":
        ids[rng.random(ids.shape) < 0.5] = -1
        ids[rng.random(ids.shape) < 0.1] = L + 3
    w = torch.from_numpy(np.exp(rng.normal(0, 12, N)))
    ids = torch.from_numpy(ids)
    want = loads_ref.ordered_cell_sum_ref(ids, w, L)
    if kind == "offset":
        ids_d = torch.empty(ids.numel() + 1, dtype=torch.int32,
                            device=card)[1:].view(H, N, S)
        w_d = torch.empty(N + 1, dtype=torch.float64, device=card)[1:]
        ids_d.copy_(ids)
        w_d.copy_(w)
        assert ids_d.data_ptr() % 16 and w_d.data_ptr() % 16
    else:
        ids_d, w_d = ids.to(card), w.to(card)
    loads_ops.reset_launches()
    got = [loads_ops.ordered_cell_sum(ids_d, w_d, L) for _ in range(2)]
    for g in got:
        assert g.device.type == "cuda" and g.shape == (S, L)
        assert torch.equal(g.cpu(), want)
    assert loads_ops.LAUNCHES == {"ordered_cell_sum": 2}


def test_ordered_cell_sum_raises_instead_of_falling_back(card, monkeypatch):
    monkeypatch.setattr(loads_ops, "ordered_cell_sum_ref", None)
    ids = torch.zeros((2, 4, 1), dtype=torch.int32, device=card)
    w = torch.ones(4, dtype=torch.float64, device=card)
    assert loads_ops.ordered_cell_sum(ids, w, 2).tolist() == [[8.0, 0.0]]
    with pytest.raises(TypeError):
        loads_ops.ordered_cell_sum(ids.long(), w, 2)


def test_dadd_latency_probe_counts_cycles(card):
    """The chain floor's float64 add latency: a few cycles an add, and
    the chain's time is the clock's cycles."""
    out = torch.zeros(3, dtype=torch.int64, device=card)
    rc = loads_build.load().dadd_latency_probe(
        out.data_ptr(), 4096, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    cycles, ns = out[:2].tolist()
    assert 2 <= cycles / 4096 < 100 and ns > 0


def test_smem_latency_probe_counts_cycles(card):
    """The chain bound's shared-memory latency: a dependent load takes
    tens of cycles, and the steps' time is the clock's cycles."""
    out = torch.zeros(34, dtype=torch.int64, device=card)
    rc = pl_build.load().smem_latency_probe(
        out.data_ptr(), 4096, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    cycles, ns = out[:2].tolist()
    assert 10 < cycles / 4096 < 200 and ns > 0


def test_placement_kernel_reports_the_plain_versions_fault(card, multipod):
    comp, flows = multipod
    case = placement_case(comp, flows, T.flow_fields_matrix(flows, "5tuple"),
                          9, "random", True, False, np.random.default_rng(2))
    for max_hops in (1, 2):
        want = port_place(comp, flows, case, "murmur", max_hops=max_hops)
        got = port_place(comp, flows, case, "murmur", device=card,
                         max_hops=max_hops)
        assert want[1] is not None and got[1] == want[1]

def test_spray_walk_launches_the_kernel_at_seven_fields(card, multipod,
                                                         monkeypatch):
    """Every hop of a sprayed walk hashes the 5-tuple and two entropy
    digits (K 8, parts (2, 4)) in one launch of the murmur grid kernel."""
    comp, flows = multipod
    widths, real = [], TV.murmur_hash_grid

    def spy(fields, dev_seed):
        widths.append(fields.shape[1])
        return real(fields, dev_seed)

    monkeypatch.setattr(TV, "murmur_hash_grid", spy)
    ops.reset_launches()
    res = T.simulate_paths(comp, flows, SEEDS, strategy="prime-spray",
                           hash_backend="murmur")
    hops = res.link_ids.shape[0]
    assert widths == [7] * hops
    assert ops.LAUNCHES["murmur_hash_grid"] == hops
    assert ops.GRID_LAUNCHES_BY_FIELDS == {7: hops}


def test_card_strategies_never_take_the_plain_hash(card, multipod,
                                                   monkeypatch):
    """On the card every walk of every strategy launches the hash kernel
    and every sequential chain the placement kernel: no plain version
    (the murmur, under every name a module of the port imports it by,
    the chain's host loop, or the CPU's ordered load sum) ever sees a
    CUDA tensor."""
    comp, flows = multipod

    def guarded(real):
        def guard(*args, **kw):
            assert all(a.device.type == "cpu" for a in args
                       if isinstance(a, torch.Tensor)), \
                "a CUDA tensor took a plain version"
            return real(*args, **kw)
        return guard

    for module in list(sys.modules.values()):
        if not getattr(module, "__name__", "").startswith("repro_torch"):
            continue
        for name in ("murmur_hash_grid_ref", "congestion_place_ref",
                     "ordered_cell_sum_ref"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name,
                                    guarded(getattr(module, name)))
    for case in ("prime-spray", "adaptive-spray", "congestion-aware",
                 "wave-path", "wave-residue", "adaptive-spray:bytes"):
        name, _, demand = case.partition(":")
        ops.reset_launches()
        pl_ops.reset_launches()
        loads_ops.reset_launches()
        res = T.simulate_paths(comp, flows, SEEDS,
                               strategy=STRATEGY_CASES[name](),
                               hash_backend="murmur",
                               demand_mode=demand or "uniform")
        chained = name == "congestion-aware" or res.residue_placed
        assert name != "wave-residue" or res.residue_placed
        assert (ops.LAUNCHES["murmur_hash_grid"] > 0
                or name == "congestion-aware"), case
        assert pl_ops.LAUNCHES["congestion_place"] == int(chained), case
        assert (loads_ops.LAUNCHES["ordered_cell_sum"] > 0) == (
            name.startswith(("adaptive", "wave"))), case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,hd", [(256, 64), (1000, 64), (333, 32),
                                  (515, 128)])
def test_flash_kernel_matches_plain_version(card, dtype, causal, S, hd):
    """GQA (8 query heads over 2 kv heads), ragged S, every head dim."""
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(card, dtype) for sh in
               ((2, 8, S, hd), (2, 2, S, hd), (2, 2, S, hd)))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_attention": 1}
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert float(fa_ref.row_errors(got, want).max()) <= fa_ref.ROW_RTOL[dtype]


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("edge", ["one_key", "under_a_tile", "tile_and_one"])
def test_flash_bf16_tile_edges(card, hd, causal, edge):
    """bf16 at S below one key tile of the kernel (1 key; half a tile
    and one) and at S one past a tile, where TMA's zero fill and the
    ragged-tile mask carry the whole result; GQA 8 over 2, every head
    dim."""
    bk = fa_ops.BF16_TILES[hd][1]
    S = {"one_key": 1, "under_a_tile": bk // 2 + 1, "tile_and_one": bk + 1}[edge]
    rng = np.random.default_rng(S * hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(card, torch.bfloat16) for sh in
               ((2, 8, S, hd), (2, 2, S, hd), (2, 2, S, hd)))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_attention": 1}
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert float(fa_ref.row_errors(got, want).max()) <= fa_ref.ROW_RTOL[
        torch.bfloat16]


def test_flash_bf16_build_short_of_registers_refuses_to_launch(
        card, tmp_path, monkeypatch):
    """A build whose bf16 kernel has fewer registers a thread than the
    block's whole share (here the source with launch bounds of 576
    threads, which cap it at 112 where 128 and 168 are the shares) would
    leave the consumers' ``setmaxnreg.inc`` waiting forever; it refuses
    to launch, and the wrapper raises and counts nothing."""
    import ctypes
    import subprocess

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import build as fa_build
    bounds = "__launch_bounds__(T::THREADS, 1)"
    text = fa_build.SOURCE.read_text()
    assert text.count(bounds) == 1
    src = tmp_path / "flash_attention_112_registers.cu"
    src.write_text(text.replace(bounds, "__launch_bounds__(576, 1)"))
    lib = src.with_suffix(".so")
    subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I",
                    str(fa_build.SOURCE.parent), "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    monkeypatch.setattr(fa_build, "load",
                        lambda: fa_build.typed(ctypes.CDLL(str(lib))))
    q = torch.zeros((1, 4, 200, 64), device=card, dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 200, 64), device=card, dtype=torch.bfloat16)
    fa_ops.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa_ops.flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_attention": 0}


def test_flash_kernel_reads_the_model_layout(card):
    """Transposed (B, S, H, hd) views go in as they are; the output comes
    back with q's strides."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(card, torch.bfloat16) for sh in
               ((1, 700, 8, 64), (1, 700, 2, 64), (1, 700, 2, 64)))
    got = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = fa_ref.flash_attention_ref(q.transpose(1, 2).contiguous(),
                                      k.transpose(1, 2).contiguous(),
                                      v.transpose(1, 2).contiguous())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert float(fa_ref.row_errors(got, want).max()) <= fa_ref.ROW_RTOL[
        torch.bfloat16]


def test_flash_launch_that_is_refused_raises(card):
    """65,536 (batch, head) pairs exceed the grid's y limit: the card
    refuses the launch and the wrapper raises instead of returning
    garbage."""
    q = torch.zeros((1, 65536, 1, 32), dtype=torch.bfloat16, device=card)
    k = torch.zeros((1, 1, 1, 32), dtype=torch.bfloat16, device=card)
    fa_ops.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa_ops.flash_attention(q, k, k)
    assert fa_ops.LAUNCHES == {"flash_attention": 0}


def test_flash_wrapper_raises_instead_of_falling_back(card):
    q = torch.zeros((1, 2, 16, 96), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 16, 72), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention(q[..., 4:68], q[..., 4:68], q[..., 4:68])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_model_and_serving_on_card_equal_cpu(card):
    """Reduced granite in f32: a 2,176-token prefill (the flash kernel,
    f32 route) and greedy generation (the cached decode) on the card
    against the CPU."""
    import dataclasses
    cfg = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), dtype="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg)
    params = cpu.init(0)
    params_gpu = _to(params, card)
    toks = torch.from_numpy(
        (np.arange(2 * 2176).reshape(2, 2176) * 7 % cfg.vocab))
    want = cpu.prefill(params, {"tokens": toks})
    fa_ops.reset_launches()
    got = gpu.prefill(params_gpu, {"tokens": toks.to(card)})
    assert fa_ops.LAUNCHES == {"flash_attention": cfg.num_layers}
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    prompt = toks[:, :5]
    want = ServeEngine(cpu, 2, 12).generate(params, prompt, steps=7)
    got = ServeEngine(gpu, 2, 12).generate(params_gpu, prompt, steps=7)
    assert torch.equal(got.cpu(), want)


def _attention_grads(fn, q, k, v, w):
    """dq, dk, dv of sum(fn(q, k, v) * w), q, k, v as leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    return torch.autograd.grad((out.float() * w).sum(), leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_on_card(card, dtype):
    """The flash op's autograd Function (the kernel forward, the
    recomputed ``chunked_attention`` backward) against autograd through
    ``plain_attention`` on the card, past ``LONG_SEQ``: 32 query heads
    over 8, hd 64, causal.  f32 within 1e-5 of each gradient's largest
    |value|; bf16 against the f32 plain gradients within bf16's 5e-2."""
    from repro_torch.models.attention import (
        LONG_SEQ, FlashAttention, plain_attention,
    )
    S = LONG_SEQ + 128
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn((1, S, h, 64), generator=gen, device=card)
               for h in (32, 8, 8))
    w = torch.randn((1, S, 32, 64), generator=gen, device=card)
    want = _attention_grads(lambda q, k, v: plain_attention(
        q, k, v, causal=True, q_offset=0), *(t.to(dtype).float()
                                             for t in (q, k, v)), w)
    fa_ops.reset_launches()
    got = _attention_grads(lambda q, k, v: FlashAttention.apply(q, k, v,
                                                                True),
                           *(t.to(dtype) for t in (q, k, v)), w)
    assert fa_ops.LAUNCHES == {"flash_attention": 1}
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = float((a.float() - b).abs().max())
        assert err <= tol * float(b.abs().max()), err


def test_flash_function_never_reaches_the_plain_version_on_card(
        card, monkeypatch):
    """On CUDA tensors the Function's forward launches the kernel and its
    backward recomputes ``chunked_attention``: the kernel's plain
    version, made to raise, is never called."""
    from repro_torch.kernels.flash_attention import ref as fa_ref_mod
    from repro_torch.models.attention import LONG_SEQ, attention_any

    def refuse(*args, **kw):
        raise AssertionError("the plain flash version ran on the card")

    monkeypatch.setattr(fa_ops, "flash_attention_ref", refuse)
    monkeypatch.setattr(fa_ref_mod, "flash_attention_ref", refuse)
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn((2, LONG_SEQ + 64, h, 64), generator=gen,
                           device=card, dtype=torch.bfloat16)
               .requires_grad_(True) for h in (8, 2, 2))
    fa_ops.reset_launches()
    out = attention_any(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_attention": 1}
    assert all(bool(torch.isfinite(g).all()) for g in grads)


#: a training sequence past ``LONG_SEQ`` (2,048)
LONG_SEQ_TRAIN = 2176


def test_train_step_on_card_equals_cpu(card):
    """Reduced granite in f32 at 2,176 tokens (past ``LONG_SEQ``: the
    Function and the kernel run): the loss within 1e-5 relative, each
    gradient leaf within 1e-4 of its largest |value|, and the weights
    after one ``train_step`` within 1e-5 of their largest |value|."""
    import dataclasses

    from repro_torch.data import SyntheticDataset
    from repro_torch.train import (
        TrainConfig, adamw_init, loss_and_grads, make_train_step,
    )
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), dtype="float32")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    params = cpu.init(0)
    params_gpu = _to(params, card)
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=LONG_SEQ_TRAIN,
                             global_batch=2, seed=1).batch(0)
    want = loss_and_grads(cpu, params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    fa_ops.reset_launches()
    got = loss_and_grads(gpu, params_gpu, {k: torch.from_numpy(v).to(card)
                                           for k, v in batch.items()})
    assert fa_ops.LAUNCHES["flash_attention"] > 0
    assert abs(got[0].item() - want[0].item()) <= 1e-5 * abs(want[0].item())
    for a, b in zip(leaves(got[2]), leaves(want[2])):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), err
    tc = TrainConfig()
    p_cpu, _, _ = make_train_step(cpu, tc)(params, adamw_init(params,
                                                             tc.optimizer),
                                           batch)
    p_gpu, _, _ = make_train_step(gpu, tc)(
        params_gpu, adamw_init(params_gpu, tc.optimizer), batch)
    for a, b in zip(leaves(p_gpu), leaves(p_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv_heads", [(32, 2), (64, 8), (16, 16)])
def test_flash_kernel_at_hd128_serving_groups(card, dtype, heads, kv_heads):
    """hd 128 at the groupings the served configs give it: glm4-9b's 32
    query heads over 2 (G 16), qwen2-72b's 64 over 8 (G 8) and
    qwen2-moe-a2.7b's 16 over 16 (G 1), causal, S 2,176."""
    S, hd = 2176, 128
    rng = np.random.default_rng(heads * kv_heads)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(card, dtype) for sh in
               ((1, heads, S, hd), (1, kv_heads, S, hd), (1, kv_heads, S, hd)))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_attention": 1}
    want = fa_ref.flash_attention_ref(q, k, v)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert float(fa_ref.row_errors(got, want).max()) <= fa_ref.ROW_RTOL[dtype]


#: the biases the init makes zero: q/k/v, the GELU MLP's and the layer
#: norms'
BIASES = ("bq", "bk", "bv", "b_in", "b_out", "ln1b", "ln2b", "lnxb",
          "final_norm_b", "enc_final_norm_b")


def _with_biases(params, seed):
    """Every bias of ``BIASES`` drawn N(0, 0.5), where the init makes
    them zero, walking the tree in its order."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v)
            elif k in BIASES:
                tree[k] = 0.5 * torch.randn(v.shape, generator=gen)
    walk(params)
    return params


def _mrope_positions(S, before, side, batch):
    """(3, batch, S) M-RoPE positions of one image of ``side`` x ``side``
    merged patches between two runs of text, as Qwen2-VL lays them
    out."""
    n = side * side
    pos = torch.empty((3, S), dtype=torch.int64)
    pos[:, :before] = torch.arange(before)
    row, col = torch.arange(n) // side, torch.arange(n) % side
    pos[0, before:before + n] = before
    pos[1, before:before + n] = before + row
    pos[2, before:before + n] = before + col
    pos[:, before + n:] = before + side + torch.arange(S - before - n)
    return pos[:, None].expand(3, batch, S).contiguous()


@pytest.mark.parametrize("name", ["glm4-9b", "codeqwen1.5-7b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "qwen2-vl-72b", "whisper-large-v3"])
def test_biased_and_moe_models_on_card_equal_cpu(card, name):
    """Reduced glm4-9b, codeqwen1.5-7b, qwen2-moe-a2.7b, deepseek-v2-lite-16b
    (MLA), qwen2-vl-72b (M-RoPE, embeddings in) and whisper-large-v3
    (the encoder-decoder) in f32 with nonzero biases: a 2,176-token
    prefill (the flash kernel a layer, none for MLA, whose prefill takes
    ``chunked_attention``; a MoE at its capacity factor, which drops
    tokens there) and greedy generation on the card against the CPU."""
    import dataclasses
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype="float32")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    params = _with_biases(cpu.init(0), 1)
    params_gpu = _to(params, card)
    S = 2176
    toks = torch.from_numpy(
        (np.arange(2 * S).reshape(2, S) * 7 % cfg.vocab))
    gen = torch.Generator().manual_seed(2)
    batch, extra = {"tokens": toks}, {}
    if cfg.family == "vlm":
        batch = {"embeds": torch.randn((2, S, cfg.d_model), generator=gen),
                 "mrope_positions": _mrope_positions(S, 100, 32, 2)}
        extra = {"mrope_positions": torch.tensor([3, 40, 70])[:, None, None]
                 .expand(3, 2, 1).contiguous()}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn(
            (2, cfg.encdec.encoder_seq, cfg.d_model), generator=gen)
    want = cpu.prefill(params, batch)
    fa_ops.reset_launches()
    got = gpu.prefill(params_gpu, _to(batch, card))
    assert fa_ops.LAUNCHES == {
        "flash_attention": 0 if cfg.mla else cfg.num_layers}
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    extra_gpu = _to(extra, card)
    if cfg.family == "encdec":
        extra = {"enc_memory": cpu.encode(params, batch["enc_embeds"])}
        extra_gpu = {"enc_memory": gpu.encode(params_gpu,
                                              batch["enc_embeds"].to(card))}
    prompt = toks[:, :5]
    want = ServeEngine(cpu, 2, 12).generate(params, prompt, steps=7,
                                            extra_batch=extra)
    got = ServeEngine(gpu, 2, 12).generate(params_gpu, prompt, steps=7,
                                           extra_batch=extra_gpu)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_g8_hd128_after_mrope(card, dtype):
    """qwen2-vl-72b's attention: 64 query heads over 8 (G 8) at hd 128,
    q and k turned by M-RoPE with the config's sections (16, 24, 24)
    over three position streams that differ, causal, S 2,176, through
    the model's (B, S, H, hd) layout: the kernel against its plain
    version."""
    from repro_torch.models.common import apply_rope, mrope_tables
    S, hd = 2176, 128
    cfg = ARCHS["qwen2-vl-72b"]
    gen = torch.Generator(device=card).manual_seed(8)
    q, k, v = (torch.randn((1, S, h, hd), generator=gen, device=card)
               for h in (64, 8, 8))
    tables = mrope_tables(_mrope_positions(S, 300, 40, 1).to(card),
                          cfg.mrope_sections, hd, cfg.rope_theta)
    q, k = (apply_rope(t, None, tables=tables).to(dtype) for t in (q, k))
    v = v.to(dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(qt, kt, vt)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_attention": 1}
    want = fa_ref.flash_attention_ref(qt, kt, vt)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert float(fa_ref.row_errors(got, want).max()) <= fa_ref.ROW_RTOL[dtype]


def test_attention_any_sends_mla_shapes_to_chunked_attention(card):
    """MLA's long prefill on the card: q/k of 192 over v of 128 (the
    full config's heads, S 2,176) takes ``chunked_attention`` by the
    shape branch, with no flash launch, and equals the CPU's."""
    from repro_torch.models import attention
    S, H = 2176, 16
    gen = torch.Generator().manual_seed(9)
    q, k = (torch.randn((1, S, H, 192), generator=gen) for _ in range(2))
    v = torch.randn((1, S, H, 128), generator=gen)
    want = attention.attention_any(q, k, v, causal=True)
    fa_ops.reset_launches()
    got = attention.attention_any(q.to(card), k.to(card), v.to(card),
                                  causal=True)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_attention": 0}
    assert got.shape == (1, S, H, 128)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    with pytest.raises(ValueError):          # the op itself refuses it
        fa_ops.flash_attention(*(t.to(card).transpose(1, 2)
                                 for t in (q, k, v)))


def test_moe_repeats_bit_for_bit_and_combines_as_the_cpu(card):
    """bf16 qwen2-moe-a2.7b (reduced): one layer's MoE on the same input
    three times gives the same bits; its combine (gathers, products and
    adds in ascending expert id, no atomics) gives the CPU's bits on the
    same expert outputs."""
    from repro_torch.models import moe
    cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
    params = Model(cfg).init(0)
    mlp = params["layers"][0]["mlp"]
    gen = torch.Generator(device=card).manual_seed(3)
    # a component shared by every token skews the routing, so that the
    # most favoured experts overflow their capacity
    x = (torch.randn((2, 4096, cfg.d_model), generator=gen, device=card)
         + 3 * torch.randn(cfg.d_model, generator=gen, device=card)
         ).to(torch.bfloat16)
    runs = [moe.moe_forward(mlp, cfg, x) for _ in range(3)]
    for y, aux in runs[1:]:
        assert torch.equal(y, runs[0][0]) and torch.equal(aux, runs[0][1])

    probs = torch.softmax((x @ mlp["router"]).float(), dim=-1)
    w, idx = moe._route(probs, cfg.moe.top_k)
    C = moe.capacity(cfg, x.shape[1])
    buf, rank = moe._dispatch(x, idx, C, cfg.moe.num_experts)
    assert int((rank >= C).sum()) > 0
    out = torch.randn(buf.shape, generator=gen, device=card).to(buf.dtype)
    on_card = moe._combine(out, w, idx, rank, C)
    on_cpu = moe._combine(out.cpu(), w.cpu(), idx.cpu(), rank.cpu(), C)
    assert torch.equal(on_card.cpu(), on_cpu)


SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _ssd_inputs(card, B, S, H, hd, N, dtype, seed):
    """x (B, S, H, hd); dt (B, S, H) as the model makes it with Mamba-2's
    init, softplus(z + dt_bias) with z ~ N(0, 1) and each head's dt_bias
    softplus^-1 of a log-uniform draw in [1e-3, 1e-1] (the chunk decays
    then carry signal); A from mamba2's linspace(1, 16, H); Bm, Cm (B, S,
    N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)) * 0.5
    u = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    dt = np.logaddexp(0, rng.standard_normal((B, S, H)) + np.log(np.expm1(u)))
    A = -np.linspace(1.0, 16.0, H)
    Bm, Cm = (rng.standard_normal((B, S, N)) * 0.3 for _ in range(2))
    f32 = (torch.float32,) * 2
    return [torch.from_numpy(a.astype(np.float32)).to(card, d) for a, d in
            zip((x, dt, A, Bm, Cm), (dtype, *f32, dtype, dtype))]


def _chunks(x, dt, A, Bm, Cm, Q):
    """The intra-chunk contract as views of sequence-major tensors."""
    B, S, H, hd = x.shape
    nc, N = S // Q, Bm.shape[-1]
    a = (dt * A).view(B, nc, Q, H).permute(0, 3, 1, 2)[..., None]
    return (a, dt.view(B, nc, Q, H).permute(0, 3, 1, 2)[..., None],
            Bm.view(B, nc, Q, N), Cm.view(B, nc, Q, N),
            x.view(B, nc, Q, H, hd).permute(0, 3, 1, 2, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,N,Q", [(2, 128, 16, 16, 16, 32),
                                          (1, 1024, 64, 64, 128, 256)])
def test_ssd_kernel_matches_plain_version(card, dtype, B, S, H, hd, N, Q):
    x, dt, A, Bm, Cm = _ssd_inputs(card, B, S, H, hd, N, dtype, S + hd)
    args = _chunks(x, dt, A, Bm, Cm, Q)
    ssd_ops.reset_launches()
    got = ssd_ops.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == {"ssd_intra_chunk": 1}
    assert got[0].permute(0, 2, 3, 1, 4).is_contiguous()     # sequence-major
    want = ssd_ref.ssd_intra_chunk_ref(*args)
    assert float(want[2].max()) > 1e-2                       # decays carry
    tol = SSD_TOL[dtype]
    for g, w, row_tol in zip(got, want, (ssd_ref.ROW_RTOL[dtype],
                                         ssd_ref.STATE_ROW_RTOL[dtype], 0)):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        if row_tol:
            assert float(ssd_ref.row_errors(g, w).max()) <= row_tol


@pytest.mark.parametrize("edge", ["heads_not_a_multiple_of_G", "one_chunk",
                                  "one_head", "padded_rows"])
def test_ssd_wgmma_tiling_edges(card, edge):
    """The bf16 wgmma body at the edges of its tiling (Q 256, N 128, hd
    64; blocks of ``BF16_BODIES`` heads): a last head group short of G, a
    single chunk, a group of one head (one x stage of the two ever used),
    and x, Bm, Cm as slices of wider rows (the tensor maps carry their
    strides).  y, S_loc and dec against the plain version."""
    G = ssd_ops.BF16_BODIES[(256, 128, 64)][1]
    B, S, H = {"heads_not_a_multiple_of_G": (1, 512, G + G // 2),
               "one_chunk": (2, 256, G), "one_head": (1, 512, 1),
               "padded_rows": (2, 512, G)}[edge]
    x, dt, A, Bm, Cm = _ssd_inputs(card, B, S, H, 64, 128, torch.bfloat16,
                                   S + H)
    if edge == "padded_rows":
        wide = torch.zeros((B, S, H, 72), dtype=x.dtype, device=card)
        wide[..., :64] = x
        x = wide[..., :64]
        bc = torch.zeros((B, S, 2, 136), dtype=x.dtype, device=card)
        bc[:, :, 0, :128], bc[:, :, 1, :128] = Bm, Cm
        Bm, Cm = bc[:, :, 0, :128], bc[:, :, 1, :128]
    args = _chunks(x, dt, A, Bm, Cm, 256)
    ssd_ops.reset_launches()
    got = ssd_ops.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == {"ssd_intra_chunk": 1}
    want = ssd_ref.ssd_intra_chunk_ref(*args)
    tol = SSD_TOL[torch.bfloat16]
    for g, w, row_tol in zip(got, want, (ssd_ref.ROW_RTOL[torch.bfloat16],
                                         ssd_ref.STATE_ROW_RTOL[torch.bfloat16],
                                         0)):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        if row_tol:
            assert float(ssd_ref.row_errors(g, w).max()) <= row_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,N,Q", [(2, 100, 16, 16, 16, 32),
                                          (1, 1000, 64, 64, 128, 256)])
def test_ssd_scan_with_kernel_equals_plain_version(card, monkeypatch, dtype,
                                                   B, S, H, hd, N, Q):
    """The whole scan, ragged S, on the card: around the kernel and around
    the plain intra-chunk version (the same glue), y and the final state.
    Both sum the chunk decays in the same order; the CPU's cumsum sums in
    f64, which moves the steepest heads (|cum| ~ 10^3) by ~1e-5 in f32."""
    args = _ssd_inputs(card, B, S, H, hd, N, dtype, S)
    ssd_ops.reset_launches()
    y, s = ssd_ops.ssd_scan(*args, chunk=Q)
    assert ssd_ops.LAUNCHES == {"ssd_intra_chunk": 1}
    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk",
                        ssd_ref.ssd_intra_chunk_ref)
    yp, sp = ssd_ops.ssd_scan(*args, chunk=Q)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, sp, atol=tol, rtol=tol)
    assert float(ssd_ref.row_errors(y, yp).max()) <= ssd_ref.ROW_RTOL[dtype]
    assert float(ssd_ref.row_errors(s, sp).max()) <= \
        ssd_ref.STATE_ROW_RTOL[dtype]


def test_ssd_bf16_build_short_of_registers_refuses_to_launch(
        card, tmp_path, monkeypatch):
    """A build whose wgmma kernel has fewer registers a thread than the
    block's whole share (here the source with launch bounds of 512
    threads, which cap it at 128 where 168 is the share) would leave the
    consumers' ``setmaxnreg.inc`` waiting forever; it refuses to launch,
    and the wrapper raises and counts nothing."""
    import ctypes
    import subprocess

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.ssd import build as ssd_build
    bounds = "__launch_bounds__(WG_THREADS, 1)"
    text = ssd_build.SOURCE.read_text()
    assert text.count(bounds) == 1
    src = tmp_path / "ssd_128_registers.cu"
    src.write_text(text.replace(bounds, "__launch_bounds__(512, 1)"))
    lib = src.with_suffix(".so")
    subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I",
                    str(ssd_build.SOURCE.parent), "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    monkeypatch.setattr(ssd_build, "load",
                        lambda: ssd_build.typed(ctypes.CDLL(str(lib))))
    x, dt, A, Bm, Cm = _ssd_inputs(card, 1, 256, 8, 64, 128, torch.bfloat16, 0)
    ssd_ops.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_ops.ssd_intra_chunk(*_chunks(x, dt, A, Bm, Cm, 256))
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == {"ssd_intra_chunk": 0}


def test_ssd_wrapper_raises_instead_of_falling_back(card):
    """Sizes, types and layouts the kernel was not built for raise on the
    card, with no fallback and no launch counted."""
    x, dt, A, Bm, Cm = _ssd_inputs(card, 1, 64, 4, 32, 16, torch.bfloat16, 0)
    ssd_ops.reset_launches()
    with pytest.raises(ValueError, match="kernel takes"):
        ssd_ops.ssd_intra_chunk(*_chunks(x, dt, A, Bm, Cm, 32))   # hd 32
    x, dt, A, Bm, Cm = _ssd_inputs(card, 1, 64, 4, 16, 16, torch.bfloat16, 0)
    a, d, b, c, xk = _chunks(x, dt, A, Bm, Cm, 32)
    with pytest.raises(ValueError, match="unit stride"):
        ssd_ops.ssd_intra_chunk(a, d, b, c, torch.empty(
            xk.shape[:3] + (16, 32), dtype=xk.dtype,
            device=card).transpose(-1, -2))
    shifted = torch.empty(xk.numel() + 1, dtype=xk.dtype, device=card)
    with pytest.raises(ValueError, match="aligned"):
        ssd_ops.ssd_intra_chunk(a, d, b, c, shifted[1:].view(xk.shape))
    with pytest.raises(TypeError):
        ssd_ops.ssd_intra_chunk(a, d, b.half(), c.half(), xk.half())
    with pytest.raises(ValueError, match="one device"):
        ssd_ops.ssd_intra_chunk(a, d, b, c, xk.cpu())
    assert ssd_ops.LAUNCHES == {"ssd_intra_chunk": 0}


def test_mamba2_on_card_equals_cpu(card):
    """Reduced mamba2 in f32: a 100-token prefill (the kernel, f32 route,
    a ragged last chunk) and greedy generation (the cached decode) on the
    card against the CPU."""
    import dataclasses
    cfg = dataclasses.replace(ARCHS["mamba2-1.3b"].reduced(), dtype="float32")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    params = cpu.init(0)
    for lp in params["layers"]:          # Mamba-2's dt range: decays carry
        u = torch.exp(torch.empty_like(lp["mixer"]["dt_bias"]).uniform_(
            np.log(1e-3), np.log(1e-1), generator=torch.Generator().manual_seed(1)))
        lp["mixer"]["dt_bias"] = torch.log(torch.expm1(u))
    params_gpu = _to(params, card)
    toks = torch.from_numpy(np.arange(2 * 100).reshape(2, 100) * 7 % cfg.vocab)
    want = cpu.prefill(params, {"tokens": toks})
    ssd_ops.reset_launches()
    got = gpu.prefill(params_gpu, {"tokens": toks.to(card)})
    assert ssd_ops.LAUNCHES == {"ssd_intra_chunk": cfg.num_layers}
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    prompt = toks[:, :5]
    want = ServeEngine(cpu, 2, 12).generate(params, prompt, steps=7)
    got = ServeEngine(gpu, 2, 12).generate(params_gpu, prompt, steps=7)
    assert torch.equal(got.cpu(), want)


def _scan_inputs(card, B, S, D, dtype, seed, N=16, R=8):
    """Selective-scan inputs on the card: x (B, S, D) and B, C (B, S, N)
    in ``dtype``, B and C column slices of one (B, S, R + 2N) projection
    as the model makes them (an odd R starts their rows off 16 bytes);
    dt log-uniform in [1e-3, 1e-1] (Mamba's init, so the state carries);
    A the reference's -(1..N)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((B, S, D), generator=gen, device=card).to(dtype)
    dbc = torch.randn((B, S, R + 2 * N), generator=gen, device=card).to(dtype)
    _, Bm, Cm = dbc.split([R, N, N], dim=-1)
    dt = torch.exp(torch.empty((B, S, D), device=card).uniform_(
        np.log(1e-3), np.log(1e-1), generator=gen))
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=card).expand(D, N).contiguous()
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D", [(2, 200, 256), (1, 64, 100), (3, 1, 64),
                                   (2, 1000, 16384), (2, 135, 320)])
def test_selective_scan_kernel_matches_plain_version(card, dtype, B, S, D):
    """y row by row within ``ref.ROW_RTOL`` and the final state equal to
    the plain loop's bit for bit: time tiles whole and ragged (S 135 is
    no multiple of the tile times the stages), a channel block cut by D
    (D 100 in bf16 starts rows off 16 bytes: the unaligned instance),
    one step, and jamba's full width."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref
    args = _scan_inputs(card, B, S, D, dtype, seed=S + D)
    ss_ops.reset_launches()
    y, h = ss_ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss_ops.LAUNCHES == {"selective_scan": 1,
                             "selective_scan_bwd": 0}
    y_p, h_p = ss_ref.selective_scan_ref(*args)
    assert float(ss_ref.row_errors(y, y_p).max()) <= ss_ref.ROW_RTOL
    assert float(ss_ref.row_errors(h, h_p).max()) <= ss_ref.ROW_RTOL
    assert torch.equal(h, h_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bc_unaligned", "x_dt_offset"])
def test_selective_scan_unaligned_rows_match_plain_version(card, dtype,
                                                           layout):
    """Rows that start off 16 bytes: B and C as slices of a projection
    of odd width R + 2N (R 5), or x and dt as slices one channel into
    wider tensors (every row off by one element); y within the row limit
    and the state bit for bit, at a ragged S and D."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref
    # each stage of the two-stage ring used twice, and a ragged tile
    B, S, D = 2, 4 * ss_ops.TILE_STEPS + 11, 200
    if layout == "bc_unaligned":
        args = _scan_inputs(card, B, S, D, dtype, seed=5, R=5)
    else:
        x, dt, A, Bm, Cm = _scan_inputs(card, B, S, D + 1, dtype, seed=6)
        args = (x[..., 1:], dt[..., 1:], A[1:].contiguous(), Bm, Cm)
    ss_ops.reset_launches()
    y, h = ss_ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss_ops.LAUNCHES == {"selective_scan": 1,
                             "selective_scan_bwd": 0}
    y_p, h_p = ss_ref.selective_scan_ref(*args)
    assert float(ss_ref.row_errors(y, y_p).max()) <= ss_ref.ROW_RTOL
    assert torch.equal(h, h_p)


@pytest.mark.parametrize("fault", sorted(SCAN_FAULTS))
def test_selective_scan_planted_faults_fail_the_row_limit(
        card, tmp_path, monkeypatch, fault):
    """The kernel's source with a planted fault (``tests/_scan_faults.py``),
    built and launched through the wrapper: the state set to 0 at each
    staged time tile, y taken with C of the step before, or a tile
    scanned from the ring stage whose copies are still in flight; each
    breaks the row limit."""
    import ctypes
    import subprocess

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.selective_scan import build as ss_build
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref
    old, new = SCAN_FAULTS[fault]
    text = ss_build.SOURCE.read_text()
    assert text.count(old) == 1
    src = tmp_path / f"selective_scan_{fault}.cu"
    src.write_text(text.replace(old, new))
    lib = src.with_suffix(".so")
    subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    monkeypatch.setattr(ss_build, "load",
                        lambda: ss_build.typed(ctypes.CDLL(str(lib))))
    args = _scan_inputs(card, 2, 3 * ss_ops.TILE_STEPS + 5, 256,
                        torch.bfloat16, seed=3)
    y, _ = ss_ops.selective_scan(*args)
    y_p, _ = ss_ref.selective_scan_ref(*args)
    assert float(ss_ref.row_errors(y, y_p).max()) > ss_ref.ROW_RTOL


def test_selective_scan_wrapper_raises_instead_of_falling_back(card):
    """A state size the kernel was not built for, a strided channel axis
    and inputs on two devices raise on the card, with no launch
    counted."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    x, dt, A, Bm, Cm = _scan_inputs(card, 1, 8, 64, torch.float32, 0)
    ss_ops.reset_launches()
    with pytest.raises(ValueError, match="N in"):
        ss_ops.selective_scan(x, dt, A[:, :8], Bm[..., :8], Cm[..., :8])
    with pytest.raises(ValueError, match="unit stride"):
        ss_ops.selective_scan(x, dt.transpose(1, 2).contiguous().transpose(
            1, 2), A, Bm, Cm)
    with pytest.raises(ValueError, match="one device"):
        ss_ops.selective_scan(x, dt, A.cpu(), Bm, Cm)
    assert ss_ops.LAUNCHES == {"selective_scan": 0,
                             "selective_scan_bwd": 0}


def test_jamba_on_card_equals_cpu(card):
    """Reduced jamba over two periods in f32, Mamba's dt init: a
    2,176-token prefill (7 scan launches and one flash launch a period,
    a MoE at its capacity factor) and greedy generation (the one-step
    recurrence, the windowed attention cache) on the card against the
    CPU."""
    import dataclasses

    from repro_torch.kernels.selective_scan import ops as ss_ops
    cfg = dataclasses.replace(ARCHS["jamba-1.5-large-398b"].reduced(),
                              dtype="float32", num_layers=16)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    params = cpu.init(0)
    gen = torch.Generator().manual_seed(1)
    for per in params["periods"]:
        for sub in per["mamba"]:
            m = sub["mixer"]
            u = torch.exp(torch.empty_like(m["dt_bias"]).uniform_(
                np.log(1e-3), np.log(1e-1), generator=gen))
            m["dt_bias"] = torch.log(torch.expm1(u))
    params_gpu = _to(params, card)
    S = 2176
    toks = torch.from_numpy(np.arange(2 * S).reshape(2, S) * 7 % cfg.vocab)
    want = cpu.prefill(params, {"tokens": toks})
    fa_ops.reset_launches()
    ss_ops.reset_launches()
    got = gpu.prefill(params_gpu, {"tokens": toks.to(card)})
    assert fa_ops.LAUNCHES == {"flash_attention": 2}
    assert ss_ops.LAUNCHES == {"selective_scan": 14,
                             "selective_scan_bwd": 0}
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    prompt = toks[:, :5]
    want = ServeEngine(cpu, 2, 12).generate(params, prompt, steps=7)
    got = ServeEngine(gpu, 2, 12).generate(params_gpu, prompt, steps=7)
    assert torch.equal(got.cpu(), want)


# -- the scans' backward (training the SSM and hybrid families) -------------


def _bwd_errors(got, want) -> dict:
    """Row errors of dx and ddt, and dA, dB, dC's largest |difference|
    relative to their largest |value|."""
    from repro_torch.kernels.selective_scan import ref as ss_ref
    out = {k: float(ss_ref.row_errors(g, w).max())
           for k, g, w in zip(("dx", "ddt"), got[:2], want[:2])}
    out.update({k: float((g - w).abs().max() / w.abs().max())
                for k, g, w in zip(("dA", "dB", "dC"), got[2:], want[2:])})
    return out


@pytest.mark.parametrize("with_gh", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D", [(2, 200, 256), (1, 64, 100), (3, 1, 64),
                                   (2, 135, 320), (2, 77, 16384),
                                   (2, 1, 40), (2, 7, 300), (2, 31, 40),
                                   (2, 33, 300), (2, 75, 300)])
def test_selective_scan_bwd_kernel_matches_plain_version(card, dtype, B, S,
                                                         D, with_gh):
    """The backward kernel against ``selective_scan_bwd_ref`` within
    ``ref.BWD_RTOL``: whole and ragged tiles and sub-tiles (S 135, 77, 7,
    31, 33, 75: the CPU model's lengths), one step, a block cut by D (D
    100 in bf16: rows off 16 bytes, B and C slices of a projection; D 40),
    a cluster cut by D (D 300, 320), jamba's full width, with and
    without the final state's cotangent; one launch, and two runs equal
    bit for bit."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref
    args = _scan_inputs(card, B, S, D, dtype, seed=S + D)
    gen = torch.Generator(device=card).manual_seed(9)
    gy = torch.randn((B, S, D), generator=gen, device=card)
    gh = (torch.randn((B, D, 16), generator=gen, device=card)
          if with_gh else None)
    ss_ops.reset_launches()
    got = ss_ops.selective_scan_bwd(*args, gy, gh)
    torch.cuda.synchronize()
    assert ss_ops.LAUNCHES == {"selective_scan": 0, "selective_scan_bwd": 1}
    want = ss_ref.selective_scan_bwd_ref(*args, gy, gh)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
    errs = _bwd_errors(got, want)
    assert max(errs.values()) <= ss_ref.BWD_RTOL, errs
    again = ss_ops.selective_scan_bwd(*args, gy, gh)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_selective_scan_bwd_reads_strided_rows(card):
    """x and dt as slices one channel into wider tensors and B, C as
    slices of an odd-width projection: every row off 16 bytes."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref
    x, dt, A, Bm, Cm = _scan_inputs(card, 2, 75, 201, torch.bfloat16, seed=8,
                                    R=5)
    args = (x[..., 1:], dt[..., 1:], A[1:].contiguous(), Bm, Cm)
    gy = torch.randn((2, 75, 200), device=card)
    got = ss_ops.selective_scan_bwd(*args, gy)
    errs = _bwd_errors(got, ss_ref.selective_scan_bwd_ref(*args, gy))
    assert max(errs.values()) <= ss_ref.BWD_RTOL, errs
    again = ss_ops.selective_scan_bwd(*args, gy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("fault", sorted(SCAN_BWD_FAULTS))
def test_selective_scan_bwd_planted_faults(card, tmp_path, monkeypatch,
                                           fault):
    """The backward's source with a planted fault
    (``tests/_scan_faults.py``'s ``BWD_FAULTS``), built and launched
    through the wrapper at ragged tiles and two clusters (S 75, D 300,
    bf16, with the final state's cotangent): a tile replayed from a zero
    state, or the carry g dropped at each tile, must break
    ``ref.BWD_RTOL``; a block's warps' partial sums added in another order
    must change the result's bits and stay within it."""
    import ctypes
    import subprocess

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.selective_scan import build as ss_build
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref
    old, new, kind = SCAN_BWD_FAULTS[fault]
    args = _scan_inputs(card, 2, 75, 300, torch.bfloat16, seed=12)
    gen = torch.Generator(device=card).manual_seed(13)
    gy = torch.randn((2, 75, 300), generator=gen, device=card)
    gh = torch.randn((2, 300, 16), generator=gen, device=card)
    right = ss_ops.selective_scan_bwd(*args, gy, gh)
    text = ss_build.SOURCE.read_text()
    assert text.count(old) == 1
    src = tmp_path / f"selective_scan_{fault}.cu"
    src.write_text(text.replace(old, new))
    lib = src.with_suffix(".so")
    subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    monkeypatch.setattr(ss_build, "load",
                        lambda: ss_build.typed(ctypes.CDLL(str(lib))))
    got = ss_ops.selective_scan_bwd(*args, gy, gh)
    errs = _bwd_errors(got, ss_ref.selective_scan_bwd_ref(*args, gy, gh))
    if kind == "limit":
        assert max(errs.values()) > ss_ref.BWD_RTOL, errs
    else:
        assert max(errs.values()) <= ss_ref.BWD_RTOL, errs
        assert not all(torch.equal(a, b) for a, b in zip(got, right))


def test_selective_scan_bwd_reads_nothing_past_its_inputs(card, tmp_path):
    """The backward on inputs that each end where their mapped device
    memory ends (``tests/_guarded_scan.py``, a process of its own): at D
    100 in bf16, rows off 16 bytes and a block past D, it reads no byte
    past them and agrees with the plain version; the source whose block
    past D points at its own first channel, past the arrays' ends
    (``_scan_faults.BWD_READ_FAULT``), faults there, so the guard page
    sees such a read."""
    import json
    import os
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.selective_scan import build as ss_build
    from repro_torch.kernels.selective_scan import ref as ss_ref
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), os.environ.get("PYTHONPATH", "")]))

    def run(*lib):
        return subprocess.run([sys.executable, str(here / "_guarded_scan.py"),
                               *lib], capture_output=True, text=True,
                              env=env, timeout=600)

    ok = run()
    assert ok.returncode == 0, ok.stderr[-2000:]
    errs = json.loads(ok.stdout.splitlines()[-1])
    assert max(errs.values()) <= ss_ref.BWD_RTOL, errs
    old, new = BWD_READ_FAULT
    text = ss_build.SOURCE.read_text()
    assert text.count(old) == 1
    src = tmp_path / "selective_scan_read_past.cu"
    src.write_text(text.replace(old, new))
    lib = src.with_suffix(".so")
    subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    bad = run(str(lib))
    assert bad.stdout.startswith("placed"), bad.stderr[-2000:]
    assert bad.returncode != 0
    assert "illegal memory access" in bad.stderr, bad.stderr[-2000:]


def test_selective_scan_bwd_wrapper_raises_instead_of_falling_back(card):
    """A state size the kernel was not built for, a strided channel axis
    and a cotangent on another device raise on the card, with no launch
    counted."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    x, dt, A, Bm, Cm = _scan_inputs(card, 1, 8, 64, torch.float32, 0)
    gy = torch.zeros((1, 8, 64), device=card)
    ss_ops.reset_launches()
    with pytest.raises(ValueError, match="N in"):
        ss_ops.selective_scan_bwd(x, dt, A[:, :8], Bm[..., :8], Cm[..., :8],
                                  gy)
    with pytest.raises(ValueError, match="unit stride"):
        ss_ops.selective_scan_bwd(x.transpose(1, 2).contiguous()
                                  .transpose(1, 2), dt, A, Bm, Cm, gy)
    with pytest.raises(ValueError, match="device"):
        ss_ops.selective_scan_bwd(x, dt, A, Bm, Cm, gy.cpu())
    assert ss_ops.LAUNCHES == {"selective_scan": 0, "selective_scan_bwd": 0}


def _refuse_plain_scans(monkeypatch):
    """Every plain version of the two scan kernels, under each name a
    module of the port holds it by, made to raise."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref

    def refuse(*args, **kw):
        raise AssertionError("a scan's plain version ran on the card")

    for mod in (ss_ops, ss_ref):
        monkeypatch.setattr(mod, "selective_scan_ref", refuse)
        monkeypatch.setattr(mod, "selective_scan_bwd_ref", refuse)
    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk_ref", refuse)
    monkeypatch.setattr(ssd_ref, "ssd_intra_chunk_ref", refuse)


def test_scan_functions_never_reach_the_plain_versions_on_card(
        card, monkeypatch):
    """On CUDA tensors ``SelectiveScan`` launches the forward and backward
    kernels and ``SSDScan`` the intra-chunk kernel, its backward
    recomputing ``ssd_twin``: no plain version of either kernel runs,
    and every gradient is finite."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.models import ssm
    _refuse_plain_scans(monkeypatch)
    x, dt, A, Bm, Cm = (t.detach().requires_grad_(True) for t in
                        _scan_inputs(card, 2, 100, 128, torch.bfloat16, 4))
    ss_ops.reset_launches()
    y, _ = ssm.SelectiveScan.apply(x, dt, A, Bm, Cm)
    grads = torch.autograd.grad(y.square().sum(), (x, dt, A, Bm, Cm))
    torch.cuda.synchronize()
    assert ss_ops.LAUNCHES == {"selective_scan": 1, "selective_scan_bwd": 1}
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.float32,
                                        torch.float32, torch.bfloat16,
                                        torch.bfloat16]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    sx, sdt, sA, sB, sC = (t.detach().requires_grad_(True) for t in
                           _ssd_inputs(card, 2, 100, 4, 16, 16,
                                       torch.bfloat16, 5))
    ssd_ops.reset_launches()
    y, _ = ssm.ssd_chunked(sx, sdt, sA, sB, sC, chunk=32)
    grads = torch.autograd.grad(y.float().square().sum(),
                                (sx, sdt, sA, sB, sC))
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == {"ssd_intra_chunk": 1}
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_gradients_on_card(card, dtype):
    """``SSDScan`` at mamba2-1.3b's SSD shape cut to S 1,024 (B 2, H 64, N
    128, hd 64, Q 256): its gradients against autograd through
    ``ssd_twin`` on the card, within 1e-5 (f32) and 5e-2 (bf16, against
    the twin in f32) of each one's largest |value|."""
    from repro_torch.models import ssm
    args = _ssd_inputs(card, 2, 1024, 64, 64, 128, dtype, 6)
    w = torch.randn((2, 1024, 64, 64), device=card)

    def grads(fn, xs):
        leaves = [t.detach().requires_grad_(True) for t in xs]
        y, _ = fn(*leaves)
        return torch.autograd.grad((y.float() * w).sum(), leaves)

    got = grads(lambda *a: ssm.SSDScan.apply(*a, 256), args)
    want = grads(lambda *a: ssm.ssd_twin(*a, chunk=256),
                 [t.float() for t in args])
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for a, g, ww in zip(args, got, want):
        assert g.dtype == a.dtype
        err = float((g.float() - ww).abs().max() / ww.abs().max())
        assert err <= tol, err


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_scan_family_train_step_on_card_equals_cpu(card, name):
    """Reduced mamba2-1.3b and jamba (one period, Mamba's dt init) in f32
    at 2,176 tokens (jamba's attention past ``LONG_SEQ``): the loss
    within 1e-5 relative, each gradient leaf within 1e-4 and each weight
    after one step within 1e-5 of its largest |value|, card against
    CPU, through the scan kernels' forward and backward.  The conv
    biases, which the init makes zero, are drawn: a leaf of zeros is
    after one step the AdamW update alone, whose last bits follow the
    division by each gradient's own size rather than the weights."""
    import dataclasses

    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.train import TrainConfig, adamw_init, make_train_step
    from repro_torch.train import step as step_mod
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype="float32")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    params = cpu.init(0)
    gen = torch.Generator().manual_seed(1)
    mixers = (params["layers"] if cfg.family == "ssm" else
              [m for per in params["periods"] for m in per["mamba"]])
    for sub in mixers:
        m = sub["mixer"]
        u = torch.exp(torch.empty_like(m["dt_bias"]).uniform_(
            np.log(1e-3), np.log(1e-1), generator=gen))
        m["dt_bias"] = torch.log(torch.expm1(u))
        for k in ("conv_b", "conv_x_b", "conv_B_b", "conv_C_b"):
            if k in m:
                m[k] = torch.randn(m[k].shape, generator=gen) * 0.5
    params_gpu = _to(params, card)
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=LONG_SEQ_TRAIN,
                             global_batch=2, seed=1).batch(0)
    seen = []
    real = step_mod.loss_and_grads

    def recording(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    step_mod.loss_and_grads = recording
    try:
        tc = TrainConfig()
        p_cpu, _, _ = make_train_step(cpu, tc)(
            params, adamw_init(params, tc.optimizer), batch)
        ss_ops.reset_launches()
        ssd_ops.reset_launches()
        p_gpu, _, _ = make_train_step(gpu, tc)(
            params_gpu, adamw_init(params_gpu, tc.optimizer), batch)
        torch.cuda.synchronize()
    finally:
        step_mod.loss_and_grads = real
    if cfg.hybrid:
        assert ss_ops.LAUNCHES["selective_scan_bwd"] == 7
        assert ss_ops.LAUNCHES["selective_scan"] >= 14
    else:
        assert ssd_ops.LAUNCHES["ssd_intra_chunk"] > cfg.num_layers
    want, got = seen
    assert abs(got[0].item() - want[0].item()) <= 1e-5 * abs(want[0].item())
    for a, b in zip(leaves(got[2]), leaves(want[2])):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), err
    for a, b in zip(leaves(p_gpu), leaves(p_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()), err


def test_mamba2_restart_on_card_is_bit_for_bit(card):
    """Reduced mamba2-1.3b in bf16 on the card: 2 steps, a checkpoint and
    2 more equal a restore and the same 2 steps, bit for bit (no atomic
    sum on the path)."""
    import tempfile

    from repro_torch.checkpoint import restore, save
    from repro_torch.data import SyntheticDataset
    from repro_torch.train import (
        AdamWConfig, TrainConfig, init_train_state, make_train_step,
    )
    from repro_torch.tree import leaves, rebuild
    cfg = ARCHS["mamba2-1.3b"].reduced()
    model = Model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), grad_accum=2)
    step = make_train_step(model, tc)
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=512, global_batch=4,
                          seed=2)

    def run(params, opt, start, n):
        for i in range(start, start + n):
            params, opt, _ = step(params, opt, ds.batch(i))
        return params, opt

    params, opt = run(*init_train_state(model, tc, 0), 0, 2)
    with tempfile.TemporaryDirectory() as d:
        state = {"params": params, "opt": opt}
        save(d, 2, state)
        template = rebuild(state, [torch.zeros_like(t) for t in leaves(state)])
        pa, oa = run(params, opt, 2, 2)
        restored, _ = restore(d, template)
        pb, ob = run(restored["params"], restored["opt"], 2, 2)
    assert all(torch.equal(a, b) for a, b in zip(leaves([pa, oa]),
                                                 leaves([pb, ob])))
