"""The port's routing strategies against the JAX package's numpy engine
(the differential reference), on the CPU.

Every registered strategy routes the same flows under the same seeds in
both packages: link ids, flowlet layout (``flow_index``) and demand
fractions must be bit-identical under both hash backends and both demand
modes, a strategy's ``extra_exposure`` within 1e-12; FIM within 1e-12
and rates, exposure, efficiency and goodput within 1e-9 relative under
``roce-nack`` and ``strack``.  The port sums link loads in the
reference's order on the CPU, so byte-weighted decisions agree too.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import strategies as RS  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core import vector_sim as TV  # noqa: E402
from repro_torch.core import vector_throughput as TT  # noqa: E402
from repro_torch.kernels.placement import ref as placement_ref  # noqa: E402
from test_torch_sim import (  # noqa: E402
    SEEDS, _bytes_flows, port_compiled, port_flows,
)

CPU = "cpu"
NAMES = R.available_strategies()
TRANSPORTS = ["roce-nack", "strack"]


@pytest.fixture(scope="module")
def paper(paper_compiled):
    """(reference compiled, port compiled, reference flows, port flows)
    for 32 paper-testbed flows of mixed volumes (mice, elephants, one
    zero-byte flow)."""
    flows = _bytes_flows()
    return paper_compiled, port_compiled(paper_compiled), flows, \
        port_flows(flows)


def _same_result(got, want):
    assert tuple(got.link_ids.shape) == want.link_ids.shape
    assert got.link_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.link_ids.numpy(), want.link_ids)
    np.testing.assert_array_equal(got.flow_index.numpy(), want.flow_index)
    np.testing.assert_array_equal(got.demand.numpy(), want.demand)
    np.testing.assert_array_equal(got.flow_demand.numpy(), want.flow_demand)
    assert got.strategy == want.strategy
    if want.extra_exposure is None:
        assert got.extra_exposure is None
    else:
        np.testing.assert_allclose(got.extra_exposure.numpy(),
                                   want.extra_exposure, rtol=1e-12, atol=0)


def _close(got: torch.Tensor, want: np.ndarray, rtol: float):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# every registered name, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("demand", ["uniform", "bytes"])
@pytest.mark.parametrize("backend", ["exact", "murmur"])
@pytest.mark.parametrize("name", NAMES)
def test_strategy_matches_numpy_engine(name, backend, demand, paper):
    ref_comp, comp, flows, tflows = paper
    want = R.simulate_paths(ref_comp, flows, SEEDS, strategy=name,
                            hash_backend=backend, demand_mode=demand)
    got = T.simulate_paths(comp, tflows, SEEDS, strategy=name,
                           hash_backend=backend, demand_mode=demand,
                           device=CPU)
    _same_result(got, want)
    assert got.is_multipath == want.is_multipath
    np.testing.assert_array_equal(got.hop_counts().numpy(),
                                  want.hop_counts())


@pytest.mark.parametrize("name", NAMES)
def test_strategy_matches_numpy_engine_on_multipod(name, multipod_small):
    fab, _, flows = multipod_small
    ref_comp = R.compile_fabric(fab)
    want = R.simulate_paths(ref_comp, flows, SEEDS, strategy=name,
                            hash_backend="murmur", fields=R.FIELDS_VXLAN)
    got = T.simulate_paths(port_compiled(ref_comp), port_flows(flows), SEEDS,
                           strategy=name, hash_backend="murmur",
                           fields=R.FIELDS_VXLAN, device=CPU)
    _same_result(got, want)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("demand", ["uniform", "bytes"])
@pytest.mark.parametrize("name", NAMES)
def test_fim_and_throughput_match_numpy_engine(name, demand, transport,
                                               paper):
    ref_comp, comp, flows, tflows = paper
    kw = dict(strategy=name, demand_mode=demand, hash_backend="murmur")
    want = R.monte_carlo_fim(ref_comp, flows, SEEDS, **kw)
    got = T.monte_carlo_fim(comp, tflows, SEEDS, device=CPU, **kw)
    _close(got.aggregate, want.aggregate, 1e-12)
    assert list(got.per_layer) == list(want.per_layer)
    want = R.monte_carlo_throughput(ref_comp, flows, SEEDS,
                                    transport=transport, **kw)
    got = T.monte_carlo_throughput(comp, tflows, SEEDS, transport=transport,
                                   device=CPU, **kw)
    assert got.transport == want.transport and got.pairs == want.pairs
    for field in ("rates", "exposure", "efficiency", "goodput", "per_pair"):
        _close(getattr(got, field), getattr(want, field), 1e-9)


def test_front_ends_route_a_strategy_in_one_pass(paper, monkeypatch):
    """Every strategy but plain ECMP routes the whole seed list at once:
    a chunk would route the wave's coupled seeds differently."""
    ref_comp, comp, flows, tflows = paper
    for module in (TV, TT):
        monkeypatch.setattr(module, "seed_chunk_size", lambda *a: 1)
    got = T.monte_carlo_fim(comp, tflows, SEEDS, strategy="prime-spray",
                            device=CPU)
    assert got.seed_chunk == len(SEEDS)
    want = R.monte_carlo_fim(ref_comp, flows, SEEDS, strategy="prime-spray")
    _close(got.aggregate, want.aggregate, 1e-12)
    tp = T.monte_carlo_throughput(comp, tflows, SEEDS, strategy="prime-spray",
                                  device=CPU)
    assert tp.seed_chunk == len(SEEDS)
    tp = T.monte_carlo_throughput(comp, tflows, SEEDS, strategy="ecmp",
                                  device=CPU)
    assert tp.seed_chunk == 1                  # plain ECMP stays chunked


# ---------------------------------------------------------------------------
# degenerate cases and the elephant layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda m: m.PrimeSpraying(flowlets=1),
    lambda m: m.PrimeSpraying(flowlets=8, min_bytes=float("inf")),
    lambda m: m.AdaptiveSpraying(flowlets=1),
    lambda m: m.EcmpStrategy(),
], ids=["k1-spray", "min-bytes-inf", "k1-adaptive", "ecmp-instance"])
def test_degenerate_strategies_are_ecmp(make, paper):
    ref_comp, comp, flows, tflows = paper
    ecmp = T.simulate_paths(comp, tflows, SEEDS, hash_backend="murmur",
                            device=CPU)
    got = T.simulate_paths(comp, tflows, SEEDS, strategy=make(T),
                           hash_backend="murmur", device=CPU)
    assert torch.equal(got.link_ids, ecmp.link_ids)
    assert not got.is_multipath and bool((got.demand == 1.0).all())
    _same_result(got, R.simulate_paths(ref_comp, flows, SEEDS,
                                       strategy=make(R),
                                       hash_backend="murmur"))
    tp = T.throughput_from_result(got, transport="roce-nack")
    assert bool((tp.exposure == 0).all()) and torch.equal(tp.goodput,
                                                          tp.rates)


def test_adaptive_one_round_is_static_spray(paper_setup_small,
                                            paper_compiled):
    _, _, flows = paper_setup_small
    comp, tflows = port_compiled(paper_compiled), port_flows(flows)
    static = T.simulate_paths(comp, tflows, SEEDS, strategy="prime-spray",
                              device=CPU)
    one = T.simulate_paths(comp, tflows, SEEDS,
                           strategy=T.AdaptiveSpraying(rounds=1), device=CPU)
    assert torch.equal(one.link_ids, static.link_ids)
    assert one.extra_exposure is None
    four = T.AdaptiveSpraying()
    assert four.with_rounds(4) is four
    two = four.with_rounds(2)
    assert (two.rounds, two.flowlets, two.move_prob) == (2, 8, 0.25)
    got = T.simulate_paths(comp, tflows, SEEDS, strategy=two, device=CPU)
    _same_result(got, R.simulate_paths(
        paper_compiled, flows, SEEDS,
        strategy=R.AdaptiveSpraying().with_rounds(2)))


def test_adaptive_spray_takes_rounds_on_the_paper_testbed(paper_setup,
                                                          paper_compiled):
    """At 256 flows the feedback fires: the port's re-spray moves
    flowlets and charges them, as the reference does."""
    _, _, flows = paper_setup
    got = T.simulate_paths(port_compiled(paper_compiled), port_flows(flows),
                           SEEDS, strategy=T.AdaptiveSpraying(), device=CPU)
    want = R.simulate_paths(paper_compiled, flows, SEEDS,
                            strategy="adaptive-spray")
    _same_result(got, want)
    assert got.rounds == 3
    assert float(got.extra_exposure.sum()) > 0


def test_elephant_layout_and_mice_on_ecmp_paths(paper):
    ref_comp, comp, flows, tflows = paper
    got = T.simulate_paths(comp, tflows, SEEDS,
                           strategy="prime-spray-elephant", device=CPU)
    want = R.simulate_paths(ref_comp, flows, SEEDS,
                            strategy="prime-spray-elephant")
    _same_result(got, want)
    k = T.PrimeSpraying(min_bytes=T.ELEPHANT_MIN_BYTES,
                        volume_k=True).flowlet_counts(tflows)
    assert sorted(set(k.tolist())) == [1, 8]      # mixed: two walks
    ecmp = T.simulate_paths(comp, tflows, SEEDS, device=CPU).link_ids
    fi = got.flow_index.numpy()
    for j in np.flatnonzero(k[fi] == 1):          # mice keep their path
        h = ecmp.shape[0]
        assert torch.equal(got.link_ids[:h, j], ecmp[:, fi[j]])


@pytest.mark.parametrize("min_bytes,volume_k", [
    (None, False), (2**20, False), (2**20, True), (1.0, True),
    (float("inf"), True), (float("inf"), False)])
def test_flowlet_counts_match_reference(min_bytes, volume_k):
    flows = _bytes_flows()
    want = R.PrimeSpraying(min_bytes=min_bytes,
                           volume_k=volume_k).flowlet_counts(flows)
    got = T.PrimeSpraying(min_bytes=min_bytes,
                          volume_k=volume_k).flowlet_counts(port_flows(flows))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 6, 7, 8, 12])
def test_entropy_labels_match_reference(k):
    np.testing.assert_array_equal(TS._balanced_parts(k), RS._balanced_parts(k))
    np.testing.assert_array_equal(T.PrimeSpraying(k).entropy_labels(),
                                  R.PrimeSpraying(k).entropy_labels())


def test_volume_less_workload_warns(paper_setup_small, paper_compiled):
    _, _, flows = paper_setup_small
    assert all(f.bytes == 0 for f in flows)
    with pytest.warns(UserWarning, match="no flow sprays, this is ECMP"):
        got = T.simulate_paths(port_compiled(paper_compiled),
                               port_flows(flows), [1, 2],
                               strategy="prime-spray-elephant", device=CPU)
    assert not got.is_multipath
    with warnings.catch_warnings():
        warnings.simplefilter("error")             # inf: no warning
        T.simulate_paths(port_compiled(paper_compiled), port_flows(flows),
                         [1], device=CPU,
                         strategy=T.PrimeSpraying(min_bytes=float("inf")))


# ---------------------------------------------------------------------------
# registry, spec and validation
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert T.available_strategies() == R.available_strategies()
    for name in NAMES:
        got, want = T.resolve_strategy(name), R.resolve_strategy(name)
        assert type(got).__name__ == type(want).__name__
        assert got.name == want.name
        assert vars(got).keys() >= {k for k in vars(want)}
        for k, v in vars(want).items():
            assert getattr(got, k) == v, (name, k)
    inst = T.PrimeSpraying(4)
    assert T.resolve_strategy(inst) is inst


def test_registry_errors_match_reference():
    with pytest.raises(ValueError) as want:
        R.resolve_strategy("no-such")
    with pytest.raises(ValueError) as got:
        T.resolve_strategy("no-such")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="already registered"):
        T.register_strategy("ecmp", T.EcmpStrategy)
    with pytest.raises(TypeError):
        T.resolve_strategy(3)
    with pytest.raises(ValueError) as got:
        T.SimSpec(device=CPU, strategy="no-such").resolve()
    assert str(got.value) == str(want.value)


def test_register_and_replace_a_strategy(monkeypatch):
    monkeypatch.setattr(TS, "_REGISTRY", dict(TS._REGISTRY))
    T.register_strategy("spray-4", lambda: T.PrimeSpraying(4))
    assert T.resolve_strategy("spray-4").flowlets == 4
    T.register_strategy("spray-4", lambda: T.PrimeSpraying(2), replace=True)
    assert T.resolve_strategy("spray-4").flowlets == 2


@pytest.mark.parametrize("name", NAMES)
def test_spec_resolves_every_registered_name(name):
    s = T.SimSpec(device=CPU, strategy=name).resolve()
    assert isinstance(s.strategy, T.RoutingStrategy)
    assert s.strategy.name == R.resolve_strategy(name).name
    assert s.resolve() == s
    assert TV._is_plain_ecmp(s.strategy) == (name == "ecmp")


@pytest.mark.parametrize("cls,kwargs", [
    ("PrimeSpraying", dict(flowlets=0)),
    ("PrimeSpraying", dict(flowlets=6, parts=(2, 2))),
    ("PrimeSpraying", dict(flowlets=4, parts=(4, 0))),
    ("PrimeSpraying", dict(min_bytes=0)),
    ("PrimeSpraying", dict(volume_k=True)),
    ("AdaptiveSpraying", dict(rounds=0)),
    ("AdaptiveSpraying", dict(ecn_factor=0)),
    ("AdaptiveSpraying", dict(respray_cost=-1)),
    ("AdaptiveSpraying", dict(move_prob=0)),
    ("WaveCongestionAware", dict(max_rounds=0)),
    ("WaveCongestionAware", dict(quantum=0)),
    ("WaveCongestionAware", dict(move_prob=1.5)),
    ("WaveCongestionAware", dict(tolerance=0.5)),
    ("WaveCongestionAware", dict(min_wave_load=-1)),
])
def test_validation_matches_reference(cls, kwargs):
    with pytest.raises(ValueError) as want:
        getattr(R, cls)(**kwargs)
    with pytest.raises(ValueError) as got:
        getattr(T, cls)(**kwargs)
    assert str(got.value) == str(want.value)


def test_strategy_needs_a_flow(paper):
    _, comp, _, _ = paper
    with pytest.raises(ValueError, match="at least one flow"):
        T.simulate_paths(comp, [], [1], strategy="prime-spray", device=CPU)


# ---------------------------------------------------------------------------
# the arithmetic that decides paths
# ---------------------------------------------------------------------------


def test_splitmix64_matches_reference():
    x = np.array([0, 1, 7, 2**63 - 1, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15],
                 np.uint64)
    got = TS._splitmix64(torch.from_numpy(x.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  RS._splitmix64(x))


@pytest.mark.parametrize("backend", ["exact", "murmur"])
def test_host_hash_is_the_port_hash(backend):
    rng = np.random.default_rng(3)
    f = rng.integers(0, 2**64 - 1, (1, 7), dtype=np.uint64)
    d = rng.integers(0, 2**64 - 1, (1, 300), dtype=np.uint64)
    want = TV.hash_grid(torch.from_numpy(f.view(np.int64)),
                        torch.from_numpy(d.view(np.int64)), backend)
    got = placement_ref.flow_hash(f, d, backend == "murmur")
    np.testing.assert_array_equal(got, want.numpy().view(np.uint64))
    np.testing.assert_array_equal(got, R.vector_sim.hash_grid(f, d, backend))


def test_cell_loads_sum_in_the_reference_order():
    """Non-dyadic weights: one bincount in C order gives the reference's
    float sums bit for bit."""
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 40, (4, 300, 9)).astype(np.int32)
    w = rng.random(300) * 3.7 + 1e-3
    got = TS._cell_loads(torch.from_numpy(ids), torch.from_numpy(w), 40)
    np.testing.assert_array_equal(got.numpy(),
                                  RS._weighted_link_loads(ids, w, 40))
    np.testing.assert_array_equal(
        TS._path_max_load(torch.from_numpy(ids), got).numpy(),
        RS._path_max_load(ids, got.numpy()))


@pytest.mark.parametrize("n", [1, 5, 8, 9, 100, 128, 129, 256, 300, 1024,
                               1031])
def test_row_sum_is_numpys_pairwise_sum(n):
    x = np.random.default_rng(n).random((6, n)) * 1e3
    np.testing.assert_array_equal(TS._row_sum(torch.from_numpy(x)).numpy(),
                                  x.sum(axis=1))


def test_byte_demand_adaptive_spray_depends_on_summation_order(
        paper_compiled):
    """Why byte-demand load sums take the ordered sum on the card, where
    a bincount sums with atomics: summing the same cells in another
    order moves some loads by an ulp, and decisions that tie in exact
    arithmetic go the other way.  Under unit demand with K = 8 every sum
    is exact and the order is immaterial."""
    wl = R.bipartite_pairs([R.server_name(i) for i in range(8)],
                           [R.server_name(8 + i) for i in range(8)],
                           flows_per_pair=16)
    flows = port_flows([dataclasses.replace(f, bytes=2**20 if j % 2 else 2**30)
                        for j, f in enumerate(R.synthesize_flows(
                            wl, nic_ip=R.nic_ip, nics_per_server=2))])
    comp, seeds = port_compiled(paper_compiled), np.arange(128)

    def shuffled(link_ids, weights, num_links):
        H, N, S = link_ids.shape
        SL = S * num_links
        flat = torch.where(link_ids >= 0, link_ids.long()
                           + torch.arange(S) * num_links, SL).reshape(-1)
        w = weights[None, :, None].expand(H, N, S).reshape(-1)
        p = torch.randperm(flat.numel(), generator=torch.Generator()
                           .manual_seed(1))
        return torch.bincount(flat[p], weights=w[p],
                              minlength=SL + 1)[:SL].reshape(S, num_links)

    def route(demand, loads):
        real = TS._cell_loads
        TS._cell_loads = loads
        try:
            return T.simulate_paths(comp, flows, seeds,
                                    strategy="adaptive-spray",
                                    demand_mode=demand, device=CPU).link_ids
        finally:
            TS._cell_loads = real

    for demand, moves in (("bytes", True), ("uniform", False)):
        a, b = route(demand, TS._cell_loads), route(demand, shuffled)
        differs = a.shape != b.shape or not torch.equal(a, b)
        assert differs == moves, demand
