"""The port's flowlet surface, segment reductions and reordering cost
against the JAX package, on the CPU.

Hand-built routed results (as in ``tests/test_reordering.py``) cross
into the port through ``interop.trace_result_from_arrays``, so exposure
and the per-parent rate sums are held against the reference on
identical inputs: per-parent minima and maxima bit for bit, per-parent
sums, exposure, efficiency and goodput within 1e-12 (numpy's
``reduceat`` sums long segments pairwise, the port in column order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import reordering as RR  # noqa: E402
from repro.core import vector_sim as RV  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.interop import trace_result_from_arrays  # noqa: E402
from test_reordering import _small_compiled_and_flows  # noqa: E402
from test_torch_sim import port_compiled, port_flows  # noqa: E402

CPU = "cpu"
INF = float("inf")


def _pair(ref_comp, flows, link_ids, **arrays):
    """(reference result, port result) of the same hand-built arrays."""
    seeds = np.arange(link_ids.shape[2], dtype=np.uint64)
    want = R.VectorTraceResult(compiled=ref_comp, flows=flows, seeds=seeds,
                               link_ids=link_ids, **arrays)
    got = trace_result_from_arrays(port_compiled(ref_comp),
                                   port_flows(flows), seeds, link_ids,
                                   device=CPU, **arrays)
    return want, got


def _two_flowlets(hops_a, hops_b, **extra):
    """One flow in two half-demand flowlets of the given path lengths."""
    comp, flows = _small_compiled_and_flows()
    ids = np.full((max(hops_a, hops_b, 1), 2, 1), -1, np.int32)
    ids[:hops_a, 0, 0] = np.arange(hops_a)
    ids[:hops_b, 1, 0] = np.arange(hops_b)
    return _pair(comp, flows[:1], ids, flow_index=np.zeros(2, np.int32),
                 demand=np.full(2, 0.5), strategy="prime-spray", **extra)


@pytest.mark.parametrize("hops", [(1, 1), (2, 5), (3, 0), (0, 0), (6, 2)])
@pytest.mark.parametrize("rates", [(10.0, 10.0), (10.0, 3.0), (10.0, INF),
                                   (INF, INF), (0.0, 4.0)])
def test_hand_built_exposure_matches_reference(hops, rates):
    want, got = _two_flowlets(*hops)
    r = np.array(rates)[:, None]
    np.testing.assert_allclose(
        T.flowlet_exposure(got, torch.from_numpy(r)).numpy(),
        R.flowlet_exposure(want, r), rtol=1e-12, atol=0)


def test_extra_exposure_is_added_on_top():
    extra = np.array([[0.25]])
    want, got = _two_flowlets(2, 4, extra_exposure=extra)
    r = np.array([[10.0], [4.0]])
    x = T.flowlet_exposure(got, torch.from_numpy(r))
    np.testing.assert_allclose(x.numpy(), R.flowlet_exposure(want, r),
                               rtol=1e-12, atol=0)
    bare = T.flowlet_exposure(_two_flowlets(2, 4)[1], torch.from_numpy(r))
    assert float(x - bare) == pytest.approx(0.25, abs=1e-15)


@pytest.mark.parametrize("transport", ["roce-nack", "strack", "ideal"])
def test_hand_built_throughput_matches_reference(transport, paper_compiled):
    """Three flows of unequal weights: one in three flowlets out of
    parent order (the scatter fallback), one single-path, one with a
    link-free flowlet; the fill itself runs in both packages."""
    _, _, flows = _small_paper()
    rng = np.random.default_rng(21)
    ids = rng.integers(0, paper_compiled.num_links, (3, 6, 4)).astype(np.int32)
    ids[:, 5] = -1                                   # link-free flowlet
    fi = np.array([1, 0, 1, 2, 1, 2], np.int32)
    demand = np.array([1 / 3, 1.0, 1 / 3, 0.5, 1 / 3, 0.5])
    want, got = _pair(paper_compiled, flows[:3], ids, flow_index=fi,
                      demand=demand, strategy="prime-spray",
                      flow_demand=np.array([2.0, 0.5, 0.5]),
                      extra_exposure=np.full((3, 4), 0.01))
    a = R.throughput_from_result(want, transport=transport)
    b = T.throughput_from_result(got, transport=transport)
    for field in ("rates", "exposure", "efficiency", "goodput", "per_pair"):
        np.testing.assert_allclose(getattr(b, field).numpy(),
                                   getattr(a, field), rtol=1e-12, atol=0,
                                   err_msg=field)


def _small_paper():
    fab = R.build_paper_testbed()
    wl = R.bipartite_pairs([R.server_name(0)], [R.server_name(8)],
                           flows_per_pair=4)
    return fab, wl, R.synthesize_flows(wl, nic_ip=R.nic_ip,
                                       nics_per_server=2)


@pytest.mark.parametrize("name", ["prime-spray", "adaptive-spray",
                                  "prime-spray-elephant"])
def test_flowlet_surface_matches_reference(name, paper_setup_small,
                                           paper_compiled):
    _, _, flows = paper_setup_small
    flows = [f if j % 3 else dataclasses.replace(f, bytes=2**30)
             for j, f in enumerate(flows)]
    seeds = [3, 2**63 + 1]
    want = R.simulate_paths(paper_compiled, flows, seeds, strategy=name,
                            demand_mode="bytes")
    got = T.simulate_paths(port_compiled(paper_compiled), port_flows(flows),
                           seeds, strategy=name, demand_mode="bytes",
                           device=CPU)
    assert (got.num_flows, got.num_flowlets, got.num_seeds) == (
        want.num_flows, want.num_flowlets, want.num_seeds)
    assert got.is_multipath == want.is_multipath
    np.testing.assert_array_equal(got.column_weights().numpy(),
                                  want.column_weights())
    np.testing.assert_allclose(got.link_flow_counts().numpy(),
                               want.link_flow_counts(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(T.fim_vector(got).numpy(),
                               R.fim_vector(want), rtol=1e-12, atol=0)
    for k in range(len(seeds)):
        a, b = want.flowlet_paths_for_seed(k), got.flowlet_paths_for_seed(k)
        assert list(a) == list(b)
        for fid in a:
            assert [[ln.name for ln in p] for p in a[fid]] == \
                [[ln.name for ln in p] for p in b[fid]]
    rates = R.max_min_rates(want)
    np.testing.assert_allclose(T.max_min_rates(got).numpy(), rates,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        T.flow_rates_from_flowlets(got, torch.from_numpy(rates)).numpy(),
        R.flow_rates_from_flowlets(want, rates), rtol=1e-12, atol=0)


def test_result_defaults_are_single_path(paper_setup_small, paper_compiled):
    _, _, flows = paper_setup_small
    got = trace_result_from_arrays(
        port_compiled(paper_compiled), port_flows(flows), [1, 2],
        np.zeros((2, len(flows), 2), np.int32), device=CPU)
    assert got.flow_index.dtype == torch.int64
    assert torch.equal(got.flow_index, torch.arange(len(flows)))
    assert bool((got.demand == 1).all()) and bool((got.flow_demand == 1).all())
    assert not got.is_multipath and got.extra_exposure is None
    assert got.column_weights() is got.demand
    assert bool((T.flowlet_exposure(got) == 0).all())
    with pytest.raises(ValueError, match="seeds"):
        trace_result_from_arrays(got.compiled, got.flows, [1],
                                 np.zeros((2, len(flows), 2)), device=CPU)
    with pytest.raises(ValueError, match=r"\(H, Nf, S\)"):
        trace_result_from_arrays(got.compiled, got.flows, [1],
                                 np.zeros((2, 3)), device=CPU)


# ---------------------------------------------------------------------------
# segment reductions
# ---------------------------------------------------------------------------


_REDUCE = {"sum": (np.add, 0.0), "amin": (np.minimum, INF),
           "amax": (np.maximum, -INF)}


@pytest.mark.parametrize("reduce", ["sum", "amin", "amax"])
@pytest.mark.parametrize("layout", ["sorted", "unsorted", "missing_parent"])
def test_segment_reduce_matches_reference(reduce, layout):
    rng = np.random.default_rng(7)
    fi = {"sorted": np.repeat(np.arange(5), [3, 1, 8, 2, 4]),
          "unsorted": rng.permutation(np.repeat(np.arange(5), 4)),
          "missing_parent": np.array([0, 0, 1, 3, 3, 4])}[layout]
    values = rng.random((fi.size, 7)) * 100
    values[1, 2] = INF
    ufunc, fill = _REDUCE[reduce]
    want = RV.segment_reduce(values, fi, 5, ufunc, fill)
    got = T.segment_reduce(torch.from_numpy(values), torch.from_numpy(fi),
                           5, reduce, fill).numpy()
    if reduce == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# round budget and efficiency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("duration,rtt,cap", [
    (0.0, 25e-6, 4), (1e-6, 25e-6, 4), (25e-6, 25e-6, 4), (26e-6, 25e-6, 4),
    (1.0, 25e-6, 4), (1e-4, 25e-6, 16), (3.3e-5, 1e-5, 1)])
def test_rtt_round_budget_matches_reference(duration, rtt, cap):
    assert T.rtt_round_budget(duration, rtt, cap) == \
        RR.rtt_round_budget(duration, rtt, cap)


@pytest.mark.parametrize("args", [(1.0, 0.0, 4), (1.0, 1e-5, 0),
                                  (-1.0, 1e-5, 4), (float("nan"), 1e-5, 4)])
def test_rtt_round_budget_rejects_like_reference(args):
    with pytest.raises(ValueError) as want:
        RR.rtt_round_budget(*args)
    with pytest.raises(ValueError) as got:
        T.rtt_round_budget(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("transport", ["ideal", "roce-nack", "strack",
                                       R.TransportProfile("t", 0.7, 0.4)])
def test_reordering_efficiency_matches_reference(transport):
    e = np.concatenate([[0.0, 1e-300, 0.25, 1.0, 4.0, 1e3],
                        np.random.default_rng(8).random(50) * 5])
    tp = (transport if isinstance(transport, str)
          else T.TransportProfile("t", 0.7, 0.4))
    got = T.reordering_efficiency(torch.from_numpy(e), tp)
    want = R.reordering_efficiency(e, transport)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    assert float(got[0]) == 1.0                    # exactly 1 at zero
    with pytest.raises(ValueError, match="non-negative"):
        T.reordering_efficiency(torch.tensor([0.1, -1e-9]), tp)


@pytest.mark.parametrize("name", ["dup-transport", "roce-nack"])
def test_register_transport_raises_like_reference(name):
    """A second profile under a registered name raises the reference's
    message in both registries (a fresh name and a published anchor);
    ``replace=True`` overwrites, and the name resolves to the new one."""
    from repro_torch.core import reordering as TR
    RR.register_transport(R.TransportProfile("dup-transport", 1.0, 0.5))
    probe = T.register_transport(T.TransportProfile("dup-transport", 1.0, 0.5))
    try:
        assert T.resolve_transport("dup-transport") is probe
        with pytest.raises(ValueError, match="already registered") as want:
            RR.register_transport(R.TransportProfile(name, 2.0, 0.5))
        with pytest.raises(ValueError, match="already registered") as got:
            T.register_transport(T.TransportProfile(name, 2.0, 0.5))
        assert str(got.value) == str(want.value)
        again = T.TransportProfile("dup-transport", 3.0, 0.5)
        assert T.register_transport(again, replace=True) is again
        assert T.resolve_transport("dup-transport") is again
    finally:
        RR._TRANSPORTS.pop("dup-transport", None)
        TR.TRANSPORTS.pop("dup-transport", None)
    assert T.available_transports() == RR.available_transports()
