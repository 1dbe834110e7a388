"""The port's time-expanded simulation against the JAX package's numpy
engine (the differential reference), on the CPU.

``departure_fill`` must give the reference's completion times bit for
bit and the same drain rounds (the same fill, the same float operations
in the same order); ``simulate_timeline`` its FIM, rates, goodput,
step durations, completion times and job completion time to 1e-9
relative, per seed, under both hash backends and both timings.  The
cases of ``tests/test_timeline.py`` and ``tests/test_event_timeline.py``
(but their ``engine="jax"`` ones) run on the port, and a one-step
schedule must equal the port's merged front ends bit for bit.  The
anchors are the JAX package's numpy-engine values at the bench shapes
(seeds 0..7), which ``chip_smoke.py`` pins for the card.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import timeline as TL  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    flows_from_records, schedule_from_records,
)
from test_torch_sim import port_compiled  # noqa: E402

CPU = "cpu"
RTOL = 1e-9
ANCHOR_SEEDS = np.arange(8)
BACKENDS = ["exact", "murmur"]

# The JAX package's numpy-engine means at seeds 0..7 (chip_smoke.py pins
# the same values): the paper-testbed LLM schedule (336 flows, 5 steps,
# byte demand, roce-nack, prime-spray-elephant) — static FIM and goodput,
# event JCT and FIM — and the multipod disjoint-elephant schedule's event
# JCT per strategy (520 flows, byte demand).
PAPER_ANCHORS = {
    "exact": (133.71512276785714, 56.92891008831366, 1.0773051353950285,
              130.64726421033623),
    "murmur": (133.58677455357144, 56.74866925820838, 1.1004450181254815,
               130.34317352396147),
}
MULTIPOD_JCT = {
    ("exact", "ecmp"): 3.01979711488,
    ("exact", "prime-spray"): 2.40459203232,
    ("exact", "wave-congestion-aware"): 1.51073741824,
    ("murmur", "ecmp"): 3.01912602624,
    ("murmur", "prime-spray"): 2.17017508928,
    ("murmur", "wave-congestion-aware"): 1.51073741824,
}
MERGED_FIM, PHASED_FIM = 189.34082589747524, 179.6630859375


def _records(flows):
    return [(f.flow_id, f.src, f.dst, f.tuple5.src_ip, f.tuple5.dst_ip,
             f.tuple5.src_port, f.tuple5.dst_port, f.tuple5.protocol,
             f.bytes, f.label) for f in flows]


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), want,
                               rtol=rtol, atol=0)


def _same_timeline(got, want, rtol=RTOL):
    """Every series of the port's ``TimelineResult`` within ``rtol`` of
    the reference's, per seed."""
    assert got.timing == want.timing and got.num_steps == want.num_steps
    np.testing.assert_array_equal(got.seeds, want.seeds)
    for name in ("weights", "fim", "goodput", "rates"):
        _close(getattr(got, name), getattr(want, name), rtol)
    for g, w in zip(got.steps, want.steps):
        assert g.step.name == w.step.name and len(g.flows) == len(w.flows)
        _close(g.fim.aggregate, w.fim.aggregate, rtol)
        for field in ("rates", "goodput", "exposure"):
            _close(getattr(g.throughput, field),
                   getattr(w.throughput, field), rtol)
    if want.job_completion is None:
        assert got.job_completion is None
        return
    for name in ("step_durations", "step_starts", "step_ends",
                 "job_completion"):
        _close(getattr(got, name), getattr(want, name), rtol)
    for g, w in zip(got.steps, want.steps):
        _close(g.completion, w.completion, rtol)


@pytest.fixture(scope="module")
def paper_llm(paper_compiled):
    """(reference compiled, port compiled, reference flows, port flows,
    reference schedule, port schedule) of the paper-testbed LLM job."""
    _, flows, _, sched = R.paper_testbed_llm_schedule()
    _, tflows, _, tsched = T.paper_testbed_llm_schedule()
    return (paper_compiled, port_compiled(paper_compiled), flows, tflows,
            sched, tsched)


@pytest.fixture(scope="module")
def elephants():
    """The multipod disjoint-elephant schedule (gradient all-reduce then
    MoE all-to-all, 520 flows) in both packages."""
    ref_comp = R.compile_fabric(R.build_multipod_fabric())
    _, flows, _, _ = R.multipod_llm_schedule(param_bytes=20_000_000_000)
    _, tflows, _, _ = T.multipod_llm_schedule(param_bytes=20_000_000_000)
    pick = (R.CH_GRAD_AR, R.CH_MOE_A2A)
    sub = [f for f in flows if R.flow_channel(f) in pick]
    tsub = [f for f in tflows if T.flow_channel(f) in pick]
    steps = [("grad-all-reduce", (R.CH_GRAD_AR,), 1.0),
             ("moe-all-to-all", (R.CH_MOE_A2A,), 1.0)]
    sched = [R.TimelineStep(*s) for s in steps]
    return (ref_comp, port_compiled(ref_comp), sub, tsub, sched,
            schedule_from_records(steps))


# ---------------------------------------------------------------------------
# departure_fill
# ---------------------------------------------------------------------------


def test_departure_fill_two_flows_one_link_analytic():
    """8 and 24 Gbit down one 100 Gb/s link: 0.16 s, then 0.32 s."""
    ids = torch.zeros((1, 2, 3), dtype=torch.int64)
    dep = T.departure_fill(ids, [100.0], [8.0, 24.0], device=CPU)
    _close(dep.completion, [[0.16] * 3, [0.32] * 3], 1e-12)
    _close(dep.duration, [0.32] * 3, 1e-12)
    assert dep.rounds == 2 and dep.fill_rounds == 2
    assert dep.completion.device.type == "cpu"


def test_departure_fill_efficiency_scales_time():
    ids = torch.zeros((1, 2, 1), dtype=torch.int64)
    dep = T.departure_fill(ids, [100.0], [8.0, 24.0],
                           efficiency=np.full((2, 1), 0.5), device=CPU)
    _close(dep.completion[:, 0], [0.32, 0.64], 1e-12)


def test_departure_fill_weighted_simultaneous():
    ids = torch.zeros((1, 2, 1), dtype=torch.int64)
    dep = T.departure_fill(ids, [100.0], [8.0, 24.0], weights=[1.0, 3.0],
                           device=CPU)
    _close(dep.completion[:, 0], [0.32, 0.32], 1e-12)
    assert dep.rounds == 1


def test_departure_fill_degenerate_columns():
    ids = torch.zeros((1, 2, 1), dtype=torch.int64)
    dep = T.departure_fill(ids, [100.0], [0.0, 10.0], device=CPU)
    _close(dep.completion[:, 0], [0.0, 0.1], 1e-12)
    ids2 = torch.tensor([[[0], [-1]]])
    dep2 = T.departure_fill(ids2, [100.0], [10.0, 10.0], device=CPU)
    _close(dep2.completion[:, 0], [0.1, 0.0], 1e-12)


def test_departure_fill_per_seed_independence():
    ids = torch.zeros((1, 2, 2), dtype=torch.int64)
    ids[0, 1, 1] = 1
    dep = T.departure_fill(ids, [100.0, 100.0], [8.0, 8.0], device=CPU)
    _close(dep.completion[:, 0], [0.16, 0.16], 1e-12)
    _close(dep.completion[:, 1], [0.08, 0.08], 1e-12)


@pytest.mark.parametrize("case", [
    ("col_gbits", ValueError, dict(col_gbits=[1.0])),
    ("finite", ValueError, dict(col_gbits=[-1.0, 1.0])),
    ("finite", ValueError, dict(col_gbits=[np.nan, 1.0])),
    ("efficiency", ValueError, dict(efficiency=np.zeros((2, 1)))),
    ("efficiency", ValueError, dict(efficiency=np.ones((2, 2)))),
    ("zero goodput", RuntimeError, dict(link_gbps=[0.0])),
    ("initial_rates", ValueError, dict(initial_rates=np.ones((3, 1)))),
    ("weights", ValueError, dict(weights=[1.0, 0.0])),
    ("link_ids", ValueError, dict(ids=np.zeros((2, 1), np.int64))),
])
def test_departure_fill_validation_matches_reference(case):
    """Each bad input raises the same error type, naming the same input,
    in both packages."""
    match, exc, kw = case
    args = dict(ids=np.zeros((1, 2, 1), np.int64), link_gbps=[100.0],
                col_gbits=[1.0, 1.0])
    args.update(kw)
    ids, cap, gb = (args.pop(k) for k in ("ids", "link_gbps", "col_gbits"))
    with pytest.raises(exc, match=match):
        R.departure_fill(ids, np.asarray(cap), np.asarray(gb), **args)
    with pytest.raises(exc, match=match):
        T.departure_fill(torch.from_numpy(ids), cap, gb, device=CPU, **args)


def test_departure_fill_initial_rates_trusted_only_when_all_start():
    """Zero-gigabit columns make the reference recompute round 1, so a
    wrong ``initial_rates`` is ignored there — and in the port."""
    ids = np.zeros((1, 2, 1), np.int64)
    bogus = np.full((2, 1), 1e-3)
    want = R.departure_fill(ids, np.array([100.0]), np.array([0.0, 10.0]),
                            initial_rates=bogus)
    got = T.departure_fill(torch.from_numpy(ids), [100.0], [0.0, 10.0],
                           initial_rates=bogus, device=CPU)
    np.testing.assert_array_equal(got.completion.numpy(), want.completion)


@pytest.mark.parametrize("trial", range(12))
def test_departure_fill_matches_reference_on_random_tensors(trial):
    """Seeded random link-id tensors with repeated links (deduplicated),
    -1 padding, zero-gigabit and linkless columns, weights, efficiency
    and reused initial rates: completion bit for bit, the same rounds."""
    rng = np.random.default_rng(1000 + trial)
    H, N, S, L = (int(rng.integers(1, 5)), int(rng.integers(1, 48)),
                  int(rng.integers(1, 7)), int(rng.integers(1, 14)))
    ids = rng.integers(-1, L, size=(H, N, S))
    gb = rng.uniform(0.5, 20.0, size=N)
    if trial % 4:
        gb[rng.random(N) < 0.2] = 0.0
    cap = rng.uniform(50.0, 200.0, size=L)
    w = rng.uniform(0.2, 3.0, size=N) if trial % 2 else None
    eff = rng.uniform(0.3, 1.0, size=(N, S)) if trial % 3 else None
    init = None
    if trial % 4 == 0:                     # every column starts active
        init = R.batched_max_min(ids, cap, weights=w)
    want = R.departure_fill(ids, cap, gb, weights=w, efficiency=eff,
                            initial_rates=init)
    got = T.departure_fill(torch.from_numpy(ids), cap, gb, weights=w,
                           efficiency=eff, initial_rates=init, device=CPU)
    np.testing.assert_array_equal(got.completion.numpy(), want.completion)
    np.testing.assert_array_equal(got.duration.numpy(), want.duration)
    assert got.rounds == want.rounds


def test_departure_fill_initial_rates_reuse_is_exact():
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(0, 6, size=(3, 8, 5)))
    gb = rng.uniform(0.5, 20.0, size=8)
    cap = rng.uniform(50.0, 200.0, size=6)
    base = T.departure_fill(ids, cap, gb, assume_unique=True, device=CPU)
    pre = T.batched_max_min(ids, cap, assume_unique=True)
    reused = T.departure_fill(ids, cap, gb, assume_unique=True,
                              initial_rates=pre, device=CPU)
    assert torch.equal(base.completion, reused.completion)
    assert reused.fill_rounds < base.fill_rounds


def test_departure_fill_needs_an_explicit_device_off_the_card():
    """``device=None`` is the card, for the drain and the timeline
    alike: without one both raise instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.departure_fill(torch.zeros((1, 2, 1), dtype=torch.int64),
                         [100.0], [8.0, 24.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.simulate_timeline(T.build_paper_testbed(),
                            T.paper_testbed_llm_schedule()[1],
                            T.paper_testbed_llm_schedule()[3], [0])


# ---------------------------------------------------------------------------
# the anchors, per seed, both backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_paper_testbed_anchor(paper_llm, backend):
    ref_comp, comp, flows, tflows, sched, tsched = paper_llm
    kw = dict(demand_mode="bytes", transport="roce-nack",
              strategy="prime-spray-elephant", hash_backend=backend)
    means = []
    for timing in ("static", "event"):
        want = R.simulate_timeline(ref_comp, flows, sched, ANCHOR_SEEDS,
                                   timing=timing, **kw)
        got = T.simulate_timeline(comp, tflows, tsched, ANCHOR_SEEDS,
                                  timing=timing, device=CPU, **kw)
        _same_timeline(got, want)
        means.append(got)
    static, event = means
    got = (float(static.fim.mean()), float(static.goodput.mean()),
           float(event.job_completion.mean()), float(event.fim.mean()))
    np.testing.assert_allclose(got, PAPER_ANCHORS[backend], rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", ["ecmp", "prime-spray",
                                      "wave-congestion-aware"])
def test_multipod_jct_anchor(elephants, strategy, backend):
    ref_comp, comp, sub, tsub, sched, tsched = elephants
    want = R.simulate_timeline(ref_comp, sub, sched, ANCHOR_SEEDS,
                               spec=R.SimSpec(
                                   demand_mode="bytes", strategy=strategy,
                                   timing="event", hash_backend=backend))
    got = T.simulate_timeline(comp, tsub, tsched, ANCHOR_SEEDS,
                              spec=T.SimSpec(
                                  demand_mode="bytes", strategy=strategy,
                                  timing="event", hash_backend=backend,
                                  device=CPU))
    _same_timeline(got, want)
    np.testing.assert_allclose(float(got.job_completion.mean()),
                               MULTIPOD_JCT[backend, strategy], rtol=RTOL)
    assert all(sr.drain_rounds >= 1 for sr in got.steps)


def test_merged_and_phased_fim_anchor(elephants):
    ref_comp, comp, sub, tsub, sched, tsched = elephants
    kw = dict(demand_mode="bytes", hash_backend="exact")
    for s_ref, s_port, anchor in ((sched, tsched, PHASED_FIM),
                                  ([R.merged_step(sched)],
                                   [T.merged_step(tsched)], MERGED_FIM)):
        want = R.simulate_timeline(ref_comp, sub, s_ref, ANCHOR_SEEDS, **kw)
        got = T.simulate_timeline(comp, tsub, s_port, ANCHOR_SEEDS,
                                  device=CPU, **kw)
        _same_timeline(got, want)
        np.testing.assert_allclose(float(got.fim.mean()), anchor,
                                   rtol=RTOL)


# ---------------------------------------------------------------------------
# the degenerate anchor: one step == the port's merged front ends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("timing", ["static", "event"])
@pytest.mark.parametrize("strategy", [
    "ecmp", "prime-spray", "prime-spray-elephant", "adaptive-spray-elephant",
    "congestion-aware",
])
def test_one_step_schedule_is_merged_snapshot(paper_llm, strategy, timing):
    ref_comp, comp, flows, tflows, sched, tsched = paper_llm
    seeds = [0, 7, 1234567]
    kw = dict(demand_mode="bytes", strategy=strategy, device=CPU)
    tl = T.simulate_timeline(comp, tflows, [T.merged_step(tsched)], seeds,
                             transport="roce-nack", timing=timing, **kw)
    mf = T.monte_carlo_fim(comp, tflows, seeds, **kw)
    mt = T.monte_carlo_throughput(comp, tflows, seeds,
                                  transport="roce-nack", **kw)
    assert tl.num_steps == 1 and float(tl.weights[0]) == 1.0
    assert torch.equal(tl.fim, mf.aggregate)
    for layer, series in mf.per_layer.items():
        assert torch.equal(tl.steps[0].fim.per_layer[layer], series)
    step = tl.steps[0].throughput
    assert torch.equal(step.rates, mt.rates)
    assert torch.equal(step.goodput, mt.goodput)
    assert torch.equal(tl.goodput, mt.goodput.mean(0))
    assert torch.equal(tl.rates, mt.rates.mean(0))
    if timing == "event":
        assert torch.equal(tl.job_completion, tl.steps[0].duration)
    # and the reference's one-step timeline to 1e-9
    want = R.simulate_timeline(ref_comp, flows, [R.merged_step(sched)],
                               seeds, demand_mode="bytes",
                               strategy=strategy, transport="roce-nack",
                               timing=timing)
    _same_timeline(tl, want)


@pytest.mark.parametrize("strategy", ["ecmp", "prime-spray-elephant"])
def test_one_step_uniform_bytes_event_matches_static(paper_llm, strategy):
    _, comp, _, tflows, _, tsched = paper_llm
    uniform = [dataclasses.replace(f, bytes=10_000_000) for f in tflows]
    one = [T.merged_step(tsched)]
    seeds = [0, 7, 1234567]
    kw = dict(demand_mode="bytes", transport="roce-nack", strategy=strategy,
              device=CPU)
    static = T.simulate_timeline(comp, uniform, one, seeds,
                                 timing=T.TIMING_STATIC, **kw)
    event = T.simulate_timeline(comp, uniform, one, seeds,
                                timing=T.TIMING_EVENT, **kw)
    for name in ("fim", "rates", "goodput"):
        assert torch.equal(getattr(event, name), getattr(static, name))
    for name in ("rates", "goodput"):
        assert torch.equal(getattr(event.steps[0].throughput, name),
                           getattr(static.steps[0].throughput, name))
    for layer, series in static.steps[0].fim.per_layer.items():
        assert torch.equal(event.steps[0].fim.per_layer[layer], series)
    assert static.job_completion is None
    assert static.timing == T.TIMING_STATIC
    assert event.timing == T.TIMING_EVENT
    assert tuple(event.job_completion.shape) == (len(seeds),)
    assert bool((event.job_completion > 0).all())
    assert torch.equal(event.job_completion, event.steps[0].duration)


# ---------------------------------------------------------------------------
# the time axis
# ---------------------------------------------------------------------------


def _two_server_fabric():
    devices = [T.Device("srv-0", "server"), T.Device("srv-1", "server"),
               T.Device("leaf-0", "leaf")]
    links = []
    for i in (0, 1):
        links.append(T.Link(f"srv-{i}", "nic0p0", "leaf-0", f"swp{i}",
                            100.0, T.HOST_TO_LEAF))
        links.append(T.Link("leaf-0", f"dwn{i}", f"srv-{i}", "nic0p0",
                            100.0, T.LEAF_TO_HOST))
    return T.Fabric(devices, links)


@pytest.mark.parametrize("strategy", ["ecmp", "prime-spray",
                                      "adaptive-spray", "congestion-aware",
                                      "wave-congestion-aware"])
def test_event_analytic_completion_per_strategy(strategy):
    """1 GB and 3 GB down one shared 100 Gb/s path: the 8-Gbit flow
    departs at 0.16 s, the job completes at 0.32 s, every strategy."""
    comp = T.compile_fabric(_two_server_fabric())
    flows = [T.Flow(flow_id=fid, src="srv-0", dst="srv-1",
                    tuple5=T.FiveTuple(T.nic_ip("srv-0", 0),
                                       T.nic_ip("srv-1", 0),
                                       10000 + fid, 20000 + fid),
                    bytes=b, label=f"xfer-{fid}#ch{T.CH_GRAD_AR}")
             for fid, b in enumerate((1_000_000_000, 3_000_000_000))]
    tl = T.simulate_timeline(
        comp, flows, [T.TimelineStep("xfer", (T.CH_GRAD_AR,))], [0, 3],
        spec=T.SimSpec(strategy=strategy, timing=T.TIMING_EVENT,
                       device=CPU))
    _close(tl.job_completion, [0.32, 0.32], 1e-9)
    _close(tl.steps[0].completion[:, 0], [0.16, 0.32], 1e-9)
    _close(tl.steps[0].duration, [0.32, 0.32], 1e-9)
    assert torch.equal(tl.step_starts, torch.zeros((1, 2),
                                                   dtype=torch.float64))
    assert torch.equal(tl.step_ends[0], tl.job_completion)
    assert torch.equal(tl.flow_completion(0), tl.steps[0].completion)


def test_event_jct_ecmp_strictly_worse_than_spray_and_wave(elephants):
    ref_comp, comp, sub, tsub, sched, tsched = elephants
    seeds = np.arange(16)
    jct = {}
    for strategy in ("ecmp", "prime-spray", "wave-congestion-aware"):
        tl = T.simulate_timeline(comp, tsub, tsched, seeds, spec=T.SimSpec(
            demand_mode="bytes", strategy=strategy, timing=T.TIMING_EVENT,
            device=CPU))
        assert tuple(tl.job_completion.shape) == (16,)
        assert bool(torch.isfinite(tl.job_completion).all())
        torch.testing.assert_close(tl.step_ends - tl.step_starts,
                                   tl.step_durations)
        assert torch.equal(tl.step_ends[-1], tl.job_completion)
        want = R.simulate_timeline(ref_comp, sub, sched, seeds,
                                   spec=R.SimSpec(demand_mode="bytes",
                                                  strategy=strategy,
                                                  timing=R.TIMING_EVENT))
        _close(tl.job_completion, want.job_completion)
        jct[strategy] = tl.job_completion
    assert bool((jct["ecmp"] > jct["prime-spray"]).all())
    assert bool((jct["ecmp"] > jct["wave-congestion-aware"]).all())
    assert jct["ecmp"].mean() > 1.2 * jct["prime-spray"].mean()
    assert jct["ecmp"].mean() > 1.5 * jct["wave-congestion-aware"].mean()


def test_event_multi_step_totals_are_per_seed_weighted(elephants):
    ref_comp, comp, sub, tsub, sched, tsched = elephants
    seeds = np.arange(4)
    tl = T.simulate_timeline(comp, tsub, tsched, seeds, spec=T.SimSpec(
        demand_mode="bytes", timing=T.TIMING_EVENT, device=CPU))
    wks = tl.step_durations / tl.step_durations.sum(0)
    assert torch.equal(tl.fim, (wks * tl.step_fim()).sum(0))
    w = tl.step_durations.mean(1)
    torch.testing.assert_close(tl.weights, w / w.sum())
    totals = T.step_byte_totals(tsub, tsched)
    np.testing.assert_array_equal(totals, R.step_byte_totals(sub, sched))
    assert totals.shape == (2,) and (totals > 0).all()
    assert totals[0] > totals[1]
    want = R.simulate_timeline(ref_comp, sub, sched, seeds, spec=R.SimSpec(
        demand_mode="bytes", timing=R.TIMING_EVENT))
    _same_timeline(tl, want)


def test_merged_overstates_disjoint_elephants(elephants):
    _, comp, _, tsub, _, tsched = elephants
    seeds = np.arange(16)
    kw = dict(demand_mode="bytes", device=CPU)
    phased = T.simulate_timeline(comp, tsub, tsched, seeds, **kw)
    merged = T.simulate_timeline(comp, tsub, [T.merged_step(tsched)],
                                 seeds, **kw)
    assert phased.num_steps == 2
    assert bool((merged.fim > phased.fim).all())
    assert merged.fim.mean() > phased.fim.mean() * 1.02
    overlap = [T.TimelineStep("overlapped", (T.CH_GRAD_AR, T.CH_MOE_A2A))]
    tl = T.simulate_timeline(comp, tsub, overlap, seeds, **kw)
    assert torch.equal(tl.fim, merged.fim)
    assert torch.equal(tl.goodput, merged.goodput)


def test_phased_series_and_weights(paper_llm):
    ref_comp, comp, flows, tflows, sched, tsched = paper_llm
    seeds = np.arange(4)
    tl = T.simulate_timeline(comp, tflows, tsched, seeds,
                             demand_mode="bytes", device=CPU)
    assert tl.num_steps == len(tsched)
    torch.testing.assert_close(tl.weights,
                               torch.full((tl.num_steps,),
                                          1.0 / tl.num_steps,
                                          dtype=torch.float64))
    torch.testing.assert_close(
        tl.fim, torch.einsum("k,ks->s", tl.weights, tl.step_fim()))
    for sr in tl.steps:
        assert {T.flow_channel(f) for f in sr.flows} <= set(sr.step.channels)
    assert sum(len(sr.flows) for sr in tl.steps) == len(tflows)
    summary = tl.summary()
    want = R.simulate_timeline(ref_comp, flows, sched, seeds,
                               demand_mode="bytes")
    want_summary = want.summary()
    assert list(summary) == list(want_summary)
    for name, row in summary.items():
        for stat, v in row.items():
            np.testing.assert_allclose(v, want_summary[name][stat],
                                       rtol=RTOL, atol=1e-12)


def test_event_adaptive_sub_rtt_step_cannot_adapt(paper_llm):
    """A transport whose RTT exceeds every derived step duration clamps
    the budget to 1 round: AdaptiveSpraying is PrimeSpraying, bit for
    bit, and the reference's result to 1e-9."""
    ref_comp, comp, flows, tflows, sched, tsched = paper_llm
    seeds = [0, 5]

    def slow(pkg):
        return pkg.TransportProfile(
            "slow-feedback", alpha=pkg.ROCE_NACK.alpha,
            floor=pkg.ROCE_NACK.floor, rtt_seconds=1e6)

    def run(strategy_cls):
        return T.simulate_timeline(comp, tflows, tsched, seeds,
                                   spec=T.SimSpec(
                                       demand_mode="bytes", transport=slow(T),
                                       strategy=strategy_cls(8),
                                       timing=T.TIMING_EVENT, device=CPU))

    adaptive = run(lambda k: T.AdaptiveSpraying(k, rounds=4))
    static = run(T.PrimeSpraying)
    for name in ("job_completion", "fim", "goodput"):
        assert torch.equal(getattr(adaptive, name), getattr(static, name))
    want = R.simulate_timeline(ref_comp, flows, sched, seeds, spec=R.SimSpec(
        demand_mode="bytes", transport=slow(R),
        strategy=R.AdaptiveSpraying(8, rounds=4), timing=R.TIMING_EVENT))
    _same_timeline(adaptive, want)


def test_event_adaptive_reroutes_with_its_rtt_budget(paper_llm):
    """Under roce-nack every derived step outlasts 4 RTTs: each step is
    re-routed with the full round budget, as the reference does."""
    ref_comp, comp, flows, tflows, sched, tsched = paper_llm
    seeds = [0, 1]
    spec = dict(demand_mode="bytes", transport="roce-nack",
                strategy="adaptive-spray-elephant", timing="event")
    got = T.simulate_timeline(comp, tflows, tsched, seeds,
                              spec=T.SimSpec(device=CPU, **spec))
    want = R.simulate_timeline(ref_comp, flows, sched, seeds,
                               spec=R.SimSpec(**spec))
    _same_timeline(got, want)


# ---------------------------------------------------------------------------
# schedules carried across, emitters and validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("timing", ["static", "event"])
def test_reference_schedule_carried_across_gives_equal_results(
        paper_llm, timing):
    """The reference's flows and DP-overlap schedule, handed to the port
    as plain records (``flows_from_records``, ``schedule_from_records``),
    give the reference's results."""
    ref_comp, comp, _, _, _, _ = paper_llm
    _, flows, _, sched = R.paper_testbed_llm_schedule(R.SCHEDULE_DP_OVERLAP)
    tflows = flows_from_records(_records(flows))
    tsched = schedule_from_records(
        (s.name, s.channels, s.duration) for s in sched)
    assert [f.label for f in tflows] == [f.label for f in flows]
    assert [dataclasses.astuple(s) for s in tsched] == \
        [dataclasses.astuple(s) for s in sched]
    seeds = [3, 4, 5]
    kw = dict(demand_mode="bytes", transport="roce-nack",
              strategy="prime-spray-elephant", timing=timing)
    want = R.simulate_timeline(ref_comp, flows, sched, seeds, **kw)
    got = T.simulate_timeline(comp, tflows, tsched, seeds, device=CPU, **kw)
    _same_timeline(got, want)


def test_schedule_from_records_validates():
    with pytest.raises(ValueError, match="no channels"):
        schedule_from_records([("empty", (), 1.0)])
    with pytest.raises(ValueError, match="duration"):
        schedule_from_records([("bad", (1,), 0.0)])


def test_llm_collective_phases_modes():
    spec = T.LlmJobSpec(num_hosts=8)
    ops, seq = T.llm_collective_phases(spec, T.SCHEDULE_SEQUENTIAL)
    assert [s.name for s in seq] == [
        "fwd-all-gather", "moe-all-to-all", "bwd-reduce-scatter",
        "grad-all-reduce", "barrier"]
    _, overlap = T.llm_collective_phases(spec, T.SCHEDULE_DP_OVERLAP)
    assert [s.name for s in overlap] == ["forward", "backward", "barrier"]
    chans = {op.channel_id for op in ops}
    for sched in (seq, overlap):
        assert {c for s in sched for c in s.channels} >= chans
    with pytest.raises(ValueError, match="unknown schedule mode"):
        T.llm_collective_phases(spec, "pipelined")


def test_moe_free_spec_drops_moe_step():
    ops, seq = T.llm_collective_phases(T.LlmJobSpec(num_hosts=8,
                                                    moe_layers=0))
    assert "moe-all-to-all" not in [s.name for s in seq]
    assert T.CH_MOE_A2A not in {op.channel_id for op in ops}


def test_timeline_step_validation():
    with pytest.raises(ValueError, match="no channels"):
        T.TimelineStep("empty", ())
    with pytest.raises(ValueError, match="duration"):
        T.TimelineStep("bad", (1,), duration=0.0)


def test_channel_vocabulary_fully_registered():
    expected = {T.CH_GRAD_AR: "CH_GRAD_AR", T.CH_FSDP_AG: "CH_FSDP_AG",
                T.CH_FSDP_RS: "CH_FSDP_RS", T.CH_MOE_A2A: "CH_MOE_A2A",
                T.CH_BARRIER: "CH_BARRIER"}
    assert len(expected) == 5
    known = T.known_channels()
    for cid, name in expected.items():
        assert T.channel_name(cid) == f"{cid} ({name})"
        assert f"{cid} ({name})" in known
    # the two packages name the same ids alike, each in its own registry
    assert R.known_channels()[:5] == known[:5]
    assert TL._CHANNEL_NAMES is not R.timeline._CHANNEL_NAMES


def test_partition_rejects_stray_and_unlabeled(paper_setup_small):
    _, tflows, _, schedule = T.paper_testbed_llm_schedule()
    with pytest.raises(ValueError, match=r"channels \[1"):
        T.partition_flows(tflows, [T.TimelineStep("only-barrier", (5,))])
    _, _, plain = paper_setup_small
    plain = flows_from_records(_records(plain))
    with pytest.raises(ValueError, match="no '#ch<N>' label"):
        T.partition_flows(plain, schedule)


def test_empty_schedule_empty_flows_and_idle_steps(paper_llm):
    _, comp, _, tflows, _, tsched = paper_llm
    with pytest.raises(ValueError, match="at least one step"):
        T.simulate_timeline(comp, tflows, [], [0], device=CPU)
    padded = list(tsched) + [T.TimelineStep("idle", (99,), duration=5.0)]
    with pytest.raises(ValueError, match=r"99.*known channels"):
        T.simulate_timeline(comp, tflows, padded, [0, 1], device=CPU)
    with pytest.raises(ValueError, match="CH_GRAD_AR"):
        T.partition_flows(tflows, padded)
    with pytest.raises(ValueError, match="empty"):
        T.simulate_timeline(comp, [], tsched, [0], device=CPU)
    with pytest.raises(ValueError, match="unknown timing"):
        T.simulate_timeline(comp, tflows, tsched, [0], device=CPU,
                            timing="wallclock")


def test_flow_completion_is_event_only(paper_llm):
    _, comp, _, tflows, _, tsched = paper_llm
    tl = T.simulate_timeline(comp, tflows, tsched, [0], device=CPU)
    with pytest.raises(ValueError, match="timing='event'"):
        tl.flow_completion(0)


def test_timeline_step_weight_alias_deprecated_once():
    TL._WEIGHT_ALIAS_WARNED = False
    with pytest.warns(DeprecationWarning, match="duration"):
        s = T.TimelineStep("x", (1,), weight=2.5)
    assert s.duration == 2.5 and s.weight == 2.5
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s2 = T.TimelineStep("y", (2,), weight=1.5)
    assert s2.duration == 1.5
    with pytest.raises(TypeError, match="alias"):
        T.TimelineStep("z", (1,), duration=1.0, weight=1.0)
    assert dataclasses.replace(s, duration=3.0).duration == 3.0


def test_unknown_channel_error_names_registered_vocabulary():
    _, tflows, _, _ = T.paper_testbed_llm_schedule()
    with pytest.raises(ValueError) as ei:
        T.partition_flows(tflows, [T.merged_step(
            [T.TimelineStep("all", (1, 2, 3, 4, 5))]),
            T.TimelineStep("ghost", (42,))])
    msg = str(ei.value)
    assert "42" in msg and "CH_MOE_A2A" in msg and "CH_GRAD_AR" in msg
    assert "1 (CH_GRAD_AR)" in T.known_channels()
    with pytest.raises(ValueError, match="empty"):
        T.partition_flows([], [T.TimelineStep("a", (1,))])


def test_register_channel_duplicate_raises():
    assert T.register_channel(1, "CH_GRAD_AR") == 1
    with pytest.raises(ValueError, match="already registered"):
        T.register_channel(1, "CH_SOMETHING_ELSE")
    before = dict(R.timeline._CHANNEL_NAMES)
    T.register_channel(93172, "CH_TEST_PORT_TMP")
    try:
        with pytest.raises(ValueError, match="replace=True"):
            T.register_channel(93172, "CH_TEST_PORT_TMP2")
        T.register_channel(93172, "CH_TEST_PORT_TMP2", replace=True)
        assert T.channel_name(93172) == "93172 (CH_TEST_PORT_TMP2)"
        # nothing leaks into the reference's registry
        assert R.timeline._CHANNEL_NAMES == before
    finally:
        TL._CHANNEL_NAMES.pop(93172, None)
