"""The port's max-min fill and throughput front end against the JAX
package's numpy engine, on the CPU, to 1e-9 relative — the tolerance of
tests/test_vector_throughput.py (the fill drains in another order, and
max-min rates are unique only up to that float drift)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import vector_throughput as RT  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import vector_throughput as TT  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    ARRAY_FIELDS, compiled_from_arrays, flows_from_records,
)

CPU = "cpu"
RTOL = 1e-9
# The JAX package's numpy engine on the paper testbed (256 bipartite
# flows, seeds 0..1023, exact backend): mean flow rate, aggregate FIM mean.
PAPER_MEAN_RATE = 18.45605006788607
PAPER_FIM_MEAN = 32.53364562988281


def port_flows(flows):
    return flows_from_records(
        (f.flow_id, f.src, f.dst, f.tuple5.src_ip, f.tuple5.dst_ip,
         f.tuple5.src_port, f.tuple5.dst_port, f.tuple5.protocol, f.bytes)
        for f in flows)


def port_compiled(ref_comp):
    fab = T.Fabric.from_json(ref_comp.fabric.to_json())
    return compiled_from_arrays(
        {k: getattr(ref_comp, k) for k in ARRAY_FIELDS}, fab,
        ref_comp.key_of_ip)


def assert_rates_close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=RTOL, atol=0)


def _random_ids(rng, H, N, S, L, holes=0.2):
    ids = rng.integers(0, L, (H, N, S)).astype(np.int32)
    ids[rng.random((H, N, S)) < holes] = -1
    return ids


# ---------------------------------------------------------------------------
# batched_max_min
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rngseed", [0, 1, 2])
def test_batched_max_min_matches_reference(weighted, rngseed):
    rng = np.random.default_rng(rngseed)
    L = 12
    ids = _random_ids(rng, 4, 40, 9, L)
    caps = rng.uniform(10.0, 400.0, L)
    w = rng.uniform(0.1, 5.0, 40) if weighted else None
    want = R.batched_max_min(ids, caps, weights=w)
    got = T.batched_max_min(torch.from_numpy(ids), caps,
                            weights=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float64
    assert_rates_close(got, want)


def test_zero_link_flow_gets_infinite_rate():
    ids = np.array([[[0], [-1]]], np.int32)          # (H=1, N=2, S=1)
    rates = T.batched_max_min(torch.from_numpy(ids), [100.0])
    assert rates[0, 0].item() == pytest.approx(100.0)
    assert torch.isinf(rates[1, 0])
    assert torch.isinf(T.batched_max_min(
        torch.full((2, 3, 2), -1, dtype=torch.int32), [100.0])).all()


@pytest.mark.parametrize("n_flows", [1, 2, 7, 16])
def test_all_flows_share_one_link(n_flows):
    rates = T.batched_max_min(torch.zeros((1, n_flows, 1), dtype=torch.int32),
                              [100.0])
    np.testing.assert_allclose(rates.numpy(), 100.0 / n_flows, rtol=1e-12)


@pytest.mark.parametrize("rngseed", [3, 4])
def test_heterogeneous_capacities(rngseed):
    rng = np.random.default_rng(rngseed)
    caps = rng.uniform(1.0, 1000.0, 5)
    ids = rng.integers(0, 5, (3, 8, 1)).astype(np.int32)
    ids[2, rng.integers(0, 8, 2), 0] = -1
    want = R.batched_max_min(ids, caps)
    assert_rates_close(T.batched_max_min(torch.from_numpy(ids), caps), want)


def test_duplicate_link_in_path_counted_once():
    ids = np.array([[[0], [0]], [[1], [-1]], [[0], [-1]]], np.int32)
    caps = np.array([100.0, 50.0])
    want = R.batched_max_min(ids, caps)
    got = T.batched_max_min(torch.from_numpy(ids), caps,
                            assume_unique=False)
    assert_rates_close(got, want)


def test_dedup_matches_reference():
    rng = np.random.default_rng(6)
    ids = rng.integers(-1, 4, (6, 20, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        T.dedup_link_ids(torch.from_numpy(ids)).numpy(),
        RT.dedup_link_ids(ids))


def test_batched_max_min_rejects_bad_input():
    with pytest.raises(ValueError):
        T.batched_max_min(torch.zeros((2, 3), dtype=torch.int32), [1.0])
    with pytest.raises(ValueError):
        T.batched_max_min(torch.zeros((1, 3, 1), dtype=torch.int32), [1.0],
                          weights=torch.tensor([1.0, 0.0, 1.0]))


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------


def _bytes_flows():
    wl = R.bipartite_pairs([R.server_name(i) for i in range(8)],
                           [R.server_name(8 + i) for i in range(8)],
                           flows_per_pair=4,
                           bytes_per_flow=[0, 1, 10, 1000, 2**20, 7, 3, 2**30])
    return R.synthesize_flows(wl, nic_ip=R.nic_ip, nics_per_server=2)


@pytest.mark.parametrize("transport", ["ideal", "roce-nack"])
@pytest.mark.parametrize("demand", ["uniform", "bytes"])
def test_monte_carlo_throughput_matches_reference(demand, transport,
                                                  paper_compiled):
    flows = _bytes_flows()
    seeds = np.arange(32)
    want = R.monte_carlo_throughput(paper_compiled, flows, seeds,
                                    demand_mode=demand, transport=transport)
    got = T.monte_carlo_throughput(port_compiled(paper_compiled),
                                   port_flows(flows), seeds,
                                   demand_mode=demand, transport=transport,
                                   device=CPU)
    assert got.transport == want.transport
    assert got.pairs == want.pairs
    assert_rates_close(got.rates, want.rates)
    assert_rates_close(got.goodput, want.goodput)
    assert_rates_close(got.per_pair, want.per_pair)
    np.testing.assert_array_equal(got.efficiency.numpy(), want.efficiency)
    np.testing.assert_array_equal(got.exposure.numpy(), want.exposure)
    for row, stats in want.summary().items():
        for k, v in stats.items():
            assert got.summary()[row][k] == pytest.approx(v, rel=RTOL)


def test_multipod_throughput_matches_reference(multipod_small):
    fab, wl, flows = multipod_small
    comp = R.compile_fabric(fab)
    want = R.monte_carlo_throughput(comp, flows, np.arange(16),
                                    hash_backend="murmur")
    got = T.monte_carlo_throughput(port_compiled(comp), port_flows(flows),
                                   np.arange(16), hash_backend="murmur",
                                   device=CPU)
    assert_rates_close(got.rates, want.rates)
    assert got.fill_rounds >= 1


def test_paper_testbed_anchor(paper_setup, paper_compiled):
    """256 flows x 1024 seeds, exact backend: the numpy engine's values."""
    _, _, flows = paper_setup
    comp, tflows = port_compiled(paper_compiled), port_flows(flows)
    seeds = np.arange(1024)
    tp = T.monte_carlo_throughput(comp, tflows, seeds, device=CPU)
    fim = T.monte_carlo_fim(comp, tflows, seeds, device=CPU)
    assert tp.rates.mean().item() == pytest.approx(PAPER_MEAN_RATE, rel=RTOL)
    assert fim.aggregate.mean().item() == pytest.approx(PAPER_FIM_MEAN,
                                                        rel=RTOL)


def test_seed_chunking_never_changes_rates(multipod_small, monkeypatch):
    fab, _, flows = multipod_small
    comp, tflows = port_compiled(R.compile_fabric(fab)), port_flows(flows)
    seeds = np.arange(40)
    whole = T.monte_carlo_throughput(comp, tflows, seeds, device=CPU)
    assert whole.seed_chunk == 40
    for chunk in (1, 9):
        monkeypatch.setattr(TT, "seed_chunk_size", lambda *a, c=chunk: c)
        part = T.monte_carlo_throughput(comp, tflows, seeds, device=CPU)
        assert part.seed_chunk == chunk
        assert torch.equal(part.rates, whole.rates)
        assert torch.equal(part.per_pair, whole.per_pair)


def test_throughput_from_result_matches_front_end(paper_setup,
                                                  paper_compiled):
    _, _, flows = paper_setup
    comp, tflows = port_compiled(paper_compiled), port_flows(flows)
    res = T.simulate_paths(comp, tflows, np.arange(16), device=CPU)
    tp = T.throughput_from_result(res, transport="strack")
    front = T.monte_carlo_throughput(comp, tflows, np.arange(16),
                                     transport="strack", device=CPU)
    assert torch.equal(tp.rates, front.rates)
    assert torch.equal(tp.rates, T.max_min_rates(res))
    assert tp.transport == "strack"


def test_goodput_is_a_copy_of_rates(paper_setup, paper_compiled):
    _, _, flows = paper_setup
    tp = T.monte_carlo_throughput(port_compiled(paper_compiled),
                                  port_flows(flows), [3], device=CPU)
    assert torch.equal(tp.goodput, tp.rates)
    tp.goodput[0, 0] = -1.0
    assert tp.rates[0, 0] != -1.0
