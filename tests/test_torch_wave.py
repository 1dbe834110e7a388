"""The port's wave-parallel congestion-aware placement against the JAX
package's numpy engine, on the CPU.

Below its cutover (or with unequal weights) the wave is the sequential
``congestion-aware`` chain; above it, the port's device formulation of
the wave walk, the conflict scan, the mover acceptance and the residue
fallback must give the reference's link ids bit for bit.  The round
loop's break and polish latch are decisions over all seeds at once, so a
seed list routes differently from its parts: the port must route the
same seed list as the reference, whole.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import strategies as RS  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from test_torch_sim import port_compiled, port_flows  # noqa: E402
from test_wave import _flows  # noqa: E402

CPU = "cpu"
SEEDS = [0, 7, 1234567, 2**40 + 17]


@pytest.fixture(scope="module")
def comps(paper_compiled):
    return paper_compiled, port_compiled(paper_compiled)


def _route(comps, flows, seeds, make, **kw):
    ref_comp, comp = comps
    want = R.simulate_paths(ref_comp, flows, seeds, strategy=make(R), **kw)
    got = T.simulate_paths(comp, port_flows(flows), seeds,
                           strategy=make(T), device=CPU, **kw)
    assert tuple(got.link_ids.shape) == want.link_ids.shape
    np.testing.assert_array_equal(got.link_ids.numpy(), want.link_ids)
    return got, want


@pytest.mark.parametrize("backend", ["exact", "murmur"])
@pytest.mark.parametrize("demand", ["uniform", "bytes"])
def test_below_cutover_is_congestion_aware(comps, demand, backend):
    flows = _flows(flows_per_pair=16, hetero=True)     # 256 < 7 * 256 links
    kw = dict(demand_mode=demand, hash_backend=backend)
    got, _ = _route(comps, flows, SEEDS,
                    lambda m: m.WaveCongestionAware(), **kw)
    seq = T.simulate_paths(comps[1], port_flows(flows), SEEDS,
                           strategy="congestion-aware", device=CPU, **kw)
    assert torch.equal(got.link_ids, seq.link_ids)
    assert got.rounds == 0


@pytest.mark.parametrize("backend", ["exact", "murmur"])
def test_hetero_weights_delegate_above_cutover(comps, backend):
    flows = _flows(flows_per_pair=120, hetero=True)
    assert len(flows) / comps[0].num_links >= 7.0
    got, _ = _route(comps, flows, np.arange(4),
                    lambda m: m.WaveCongestionAware(),
                    demand_mode="bytes", hash_backend=backend)
    assert got.rounds == 0


@pytest.mark.parametrize("backend", ["exact", "murmur"])
@pytest.mark.parametrize("demand", ["uniform", "bytes"])
def test_above_cutover_matches_reference_wave(comps, demand, backend):
    """2,560 flows x 8 seeds: the wave path proper, its repair rounds
    and, at this depth, the residue fallback at the round cap."""
    flows = _flows(flows_per_pair=160)
    assert len(flows) / comps[0].num_links >= 7.0
    got, want = _route(comps, flows, np.arange(8),
                       lambda m: m.WaveCongestionAware(),
                       demand_mode=demand, hash_backend=backend)
    assert got.rounds == 16 and got.residue_placed
    ecmp = R.simulate_paths(comps[0], flows, np.arange(8),
                            hash_backend=backend)
    assert T.fim_vector(got).mean() < R.fim_vector(ecmp).mean()
    np.testing.assert_allclose(T.fim_vector(got).numpy(),
                               R.fim_vector(want), rtol=1e-12, atol=0)


def test_seed_list_is_routed_whole(comps):
    """The seed coupling: seeds 0 and 1 of a 16-seed wave route other
    link ids than a 2-seed wave, in the reference and in the port; the
    port gives the reference's 16-seed run."""
    flows = _flows(flows_per_pair=160)
    got16, want16 = _route(comps, flows, np.arange(16),
                           lambda m: m.WaveCongestionAware(),
                           hash_backend="murmur")
    got2, want2 = _route(comps, flows, np.arange(2),
                         lambda m: m.WaveCongestionAware(),
                         hash_backend="murmur")
    assert not np.array_equal(want16.link_ids[..., :2], want2.link_ids)
    assert not torch.equal(got16.link_ids[..., :2], got2.link_ids)


def test_round_cap_residue_falls_back_to_the_sequential_loop(comps):
    flows = _flows(flows_per_pair=16)
    got, _ = _route(
        comps, flows, np.arange(4),
        lambda m: m.WaveCongestionAware(max_rounds=1, min_wave_load=0.0),
        hash_backend="murmur")
    assert got.rounds == 1 and got.residue_placed
    tflows = {f.flow_id: f for f in port_flows(flows)}
    paths = got.flowlet_paths_for_seed(0)
    assert set(paths) == set(tflows)
    for fid, (path,) in paths.items():
        assert path[0].src == tflows[fid].src
        assert path[-1].dst == tflows[fid].dst
        assert all(a.dst == b.src for a, b in zip(path, path[1:]))


def test_two_flow_symmetric_conflict_matches_reference(comps):
    flows = _flows(flows_per_pair=1, servers=2)
    _route(comps, flows, list(range(64)),
           lambda m: m.WaveCongestionAware(tolerance=1.0, min_wave_load=0.0),
           hash_backend="exact")


# ---------------------------------------------------------------------------
# the wave's pieces against the reference's numpy functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cool,near", [(False, False), (True, False),
                                       (True, True)])
def test_wave_choice_matches_reference(cool, near):
    rng = np.random.default_rng(11)
    shape, cw = (40, 9), 6
    cands = rng.integers(-1, 50, shape + (cw,)).astype(np.int64)
    valid = (rng.random(shape + (cw,)) < 0.8) & (cands >= 0)
    cl = np.where(valid, rng.integers(0, 4, shape + (cw,)).astype(float),
                  np.inf)
    h = rng.integers(0, 2**64 - 1, shape, dtype=np.uint64)
    want = RS._wave_choice(cands, valid, cl, h, cw, cool, near)
    got = TS._wave_choice(torch.from_numpy(cands), torch.from_numpy(valid),
                          torch.from_numpy(cl),
                          torch.from_numpy(h.view(np.int64)), cw, cool, near)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mover_accept_matches_reference():
    rng = np.random.default_rng(12)
    na, S, L = 30, 5, 20
    old = rng.integers(-1, L, (4, na, S)).astype(np.int32)
    new = np.where(rng.random((3, na, S)) < 0.5, old[:3],
                   rng.integers(-1, L, (3, na, S))).astype(np.int32)
    loads = rng.integers(0, 6, (S, L)).astype(float)
    w = np.ones(na)
    want = RS._mover_accept(new, old, loads, w, 1.0)
    got = TS._mover_accept(torch.from_numpy(new), torch.from_numpy(old),
                           torch.from_numpy(loads), torch.from_numpy(w), 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("tol", [1.0, 2.0])
def test_wave_conflicts_match_reference(comps, tol):
    ref_comp, comp = comps
    flows = _flows(flows_per_pair=40)
    seeds = np.arange(6, dtype=np.uint64)
    ends = ref_comp.flow_endpoint_ids(flows)
    ids = R.simulate_paths(ref_comp, flows, seeds).link_ids
    loads = RS._scatter_cell_loads(
        ids, np.ones(len(flows)), np.arange(6, dtype=np.int64)
        * ref_comp.num_links, ref_comp.num_links)
    want = RS._wave_conflicts(ref_comp, ids, ends[0], ends[2], ends[3],
                              loads, np.ones(len(flows)), quantum=1.0,
                              tol=tol)
    t = [torch.from_numpy(a.astype(np.int64)) for a in ends]
    got = TS._wave_conflicts(comp, torch.from_numpy(ids), t[0], t[2], t[3],
                             torch.from_numpy(loads), quantum=1.0, tol=tol)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[0].any()


def test_wave_walk_matches_reference(comps):
    ref_comp, comp = comps
    flows = _flows(flows_per_pair=40)
    seeds = np.arange(6, dtype=np.uint64)
    ends = ref_comp.flow_endpoint_ids(flows)
    fm = R.flow_fields_matrix(flows, R.FIELDS_5TUPLE)
    loads = np.random.default_rng(13).integers(
        0, 5, (6, ref_comp.num_links)).astype(float)
    t = [torch.from_numpy(a.astype(np.int64)) for a in ends]
    for cool, near in ((False, False), (True, False), (True, True)):
        want = RS._wave_walk_numpy(
            ref_comp, *ends, fm, seeds, loads, hash_backend="murmur",
            max_hops=16, quantum=1.0, cool=cool, near=near)
        got = TS._wave_walk(
            comp, t[0], t[2], t[3], torch.from_numpy(fm.view(np.int64)),
            torch.from_numpy(seeds.view(np.int64)), torch.from_numpy(loads),
            hash_backend="murmur", max_hops=16, quantum=1.0, cool=cool,
            near=near)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_wave_route_bench_shape_gives_its_recorded_rows():
    """``benchmarks/wave_route.py``'s shape (2,560 flows x 8 seeds, the
    numpy engine's exact hash): the port's sequential and wave FIM means
    are the ones ``BENCH_results.json`` records for the numpy engine."""
    rows = {r["name"]: r["metrics"].get("fim") for r in json.loads(
        (Path(__file__).resolve().parent.parent / "BENCH_results.json")
        .read_text())["rows"] if r.get("bench") == "wave_route"}
    comp = T.compile_fabric(T.build_paper_testbed())
    flows = port_flows(_flows(flows_per_pair=160))
    for name, row in (("congestion-aware", "wave_route_sequential"),
                      ("wave-congestion-aware", "wave_route_wave_numpy")):
        fim = T.fim_vector(T.simulate_paths(comp, flows, np.arange(8),
                                            strategy=name, device=CPU))
        assert round(float(fim.mean()), 2) == rows[row], name
