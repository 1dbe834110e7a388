"""The port's static routing and placement (``core/placement.py``,
``StaticRouting``) against the JAX package's, on the CPU, and the
paper's Fig. 3 comparison on the port.

``static_route_assignment`` must give the reference's table and paths in
both modes; the reference's table must drive the port's
``StaticRouting`` to the same paths; and the system checks of
``tests/test_system.py`` must hold on the port: ECMP FIM 29.1015625 at
seed 7, static FIM 0.0 with 1,024 table entries and every pair at line
rate, a reduction of at least 15 points, ``hop_greedy`` at 25.0."""

import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core.placement import enumerate_paths as r_enumerate_paths  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.placement import enumerate_paths  # noqa: E402
from repro_torch.interop import flows_from_records  # noqa: E402

MODES = ["minmax", "hop_greedy"]
FABRICS = ["paper", "paper_small", "multipod"]


def port_flows(flows):
    return flows_from_records(
        (f.flow_id, f.src, f.dst, f.tuple5.src_ip, f.tuple5.dst_ip,
         f.tuple5.src_port, f.tuple5.dst_port, f.tuple5.protocol, f.bytes)
        for f in flows)


def names(paths):
    return {k: [ln.name for ln in v] for k, v in paths.items()}


@pytest.fixture(scope="module")
def setups(paper_setup, paper_setup_small, multipod_small):
    """fabric name -> ((reference fabric, flows), (the port's))."""
    return {name: ((fab, flows), (T.Fabric.from_json(fab.to_json()),
                                  port_flows(flows)))
            for name, (fab, _, flows) in (("paper", paper_setup),
                                          ("paper_small", paper_setup_small),
                                          ("multipod", multipod_small))}


@pytest.fixture(scope="module")
def assignments(setups):
    """(fabric, mode) -> (reference (table, paths), the port's)."""
    out = {}
    for name, ((rf, rfl), (tf, tfl)) in setups.items():
        for mode in MODES:
            out[name, mode] = (R.static_route_assignment(rf, rfl, mode=mode),
                               T.static_route_assignment(tf, tfl, mode=mode))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fabric", FABRICS)
def test_static_assignment_matches_reference(assignments, setups, fabric,
                                             mode):
    (r_table, r_paths), (table, paths) = assignments[fabric, mode]
    assert table == r_table
    assert list(table) == list(r_table)
    assert names(paths) == names(r_paths)
    assert list(paths) == list(r_paths)
    (rf, _), (tf, _) = setups[fabric]
    assert T.fim(paths, tf) == R.fim(r_paths, rf)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fabric", FABRICS)
def test_reference_table_drives_the_port(assignments, setups, fabric, mode):
    """The reference's table through the port's ``StaticRouting`` and
    tracer (8 threads) reproduces the planned paths."""
    (r_table, r_paths), _ = assignments[fabric, mode]
    _, (tf, tfl) = setups[fabric]
    twl = T.workload_from_flows(tfl)
    res = T.FlowTracer(tf, T.StaticRouting(tf, r_table), twl, tfl,
                       num_threads=8).trace()
    assert names(res.paths) == names(r_paths)


def test_static_routing_raises_without_an_entry(setups):
    messages = []
    for pkg, (fab, flows) in zip((R, T), setups["paper_small"]):
        with pytest.raises(KeyError) as err:
            pkg.FlowTracer(fab, pkg.StaticRouting(fab, {}),
                           pkg.workload_from_flows(flows), flows).trace()
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "static table has no entry" in messages[1]


def test_unknown_mode_raises(setups):
    _, (tf, tfl) = setups["paper_small"]
    with pytest.raises(ValueError):
        T.static_route_assignment(tf, tfl, mode="greedy")


@pytest.mark.parametrize("fabric", FABRICS)
def test_enumerate_paths_counts(setups, fabric):
    (rf, rfl), (tf, tfl) = setups[fabric]
    fwd, rfwd = T.Forwarder(tf), R.Forwarder(rf)
    for j in (0, len(tfl) // 2, len(tfl) - 1):
        got = enumerate_paths(tf, fwd, tfl[j])
        want = r_enumerate_paths(rf, rfwd, rfl[j])
        assert [[ln.name for ln in p] for p in got] == [
            [ln.name for ln in p] for p in want]
        assert all(p[0].src == tfl[j].src and p[-1].dst == tfl[j].dst
                   for p in got)
        # the cap is checked between devices, so a last device's
        # candidates may overshoot it, as in the reference
        capped = enumerate_paths(tf, fwd, tfl[j], max_paths=5)
        assert [[ln.name for ln in p] for p in capped] == [
            [ln.name for ln in p]
            for p in r_enumerate_paths(rf, rfwd, rfl[j], max_paths=5)]
        assert 5 <= len(capped) < len(got)
    if fabric.startswith("paper"):
        # 2 (src LAG) x 16 (uplinks) x 4 (spine downlinks) x 2 (dst LAG)
        assert len(got) == 256


@pytest.mark.parametrize("pods,chips_per_pod", [(2, 2), (2, 16), (3, 5),
                                                (4, 8), (4, 16)])
def test_topology_aware_ring_matches_reference(pods, chips_per_pod):
    devices = list(range(pods * chips_per_pod))
    coords = {d: (d % pods, d // 2, d % 2) for d in devices}  # interleaved
    ring = T.topology_aware_ring(devices, coords)
    assert ring == R.topology_aware_ring(devices, coords)
    for group in (devices, ring):
        assert T.ring_edge_stats(group, coords) == R.ring_edge_stats(
            group, coords)
    assert T.ring_edge_stats(ring, coords)["inter_pod"] == pods
    assert sum(T.ring_edge_stats(devices, coords).values()) == len(devices)


@pytest.mark.parametrize("num_flows,num_ports", [(0, 3), (7, 1), (16, 4),
                                                 (10, 3)])
def test_balanced_port_spread_matches_reference(num_flows, num_ports):
    got = T.balanced_port_spread(num_flows, num_ports)
    assert got == R.balanced_port_spread(num_flows, num_ports)
    assert len(got) == num_flows


@pytest.mark.parametrize("fpp", [4, 8, 12])
def test_static_assignment_balances_divisible_workloads(fpp):
    """Any bipartite workload whose flow count divides the link count is
    balanced to FIM == 0 by the min-max assigner."""
    fab = T.build_paper_testbed()
    wl = T.bipartite_pairs([T.server_name(i) for i in range(8)],
                           [T.server_name(8 + i) for i in range(8)],
                           flows_per_pair=fpp)
    flows = T.synthesize_flows(wl, nic_ip=T.nic_ip)
    _, paths = T.static_route_assignment(fab, flows)
    assert T.fim(paths, fab) == pytest.approx(0.0, abs=1e-9)


# ---------------------------------------------------------------------------
# the paper's Fig. 3 comparison on the port (tests/test_system.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fig3(setups, assignments):
    _, (tf, tfl) = setups["paper"]
    twl = T.workload_from_flows(tfl)
    ecmp = T.FlowTracer(tf, T.EcmpRouting(tf, seed=7), twl, tfl,
                        num_threads=8).trace()
    return tf, twl, tfl, ecmp, assignments["paper", "minmax"][1]


def test_ecmp_imbalance_at_seed_7(fig3):
    tf, _, _, ecmp, _ = fig3
    assert len(ecmp.paths) == 256
    assert T.fim(ecmp.paths, tf) == 29.1015625


def test_static_routing_balances(fig3):
    tf, twl, tfl, _, (table, paths) = fig3
    assert T.fim(paths, tf) == pytest.approx(0.0, abs=1e-9)
    assert len(table) == 1024
    assert all(abs(t - 400.0) < 1e-6
               for t in T.per_pair_throughput(tfl, paths).values())
    res = T.FlowTracer(tf, T.StaticRouting(tf, table), twl, tfl,
                       num_threads=8).trace()
    assert names(res.paths) == names(paths)


def test_imbalance_reduction_matches_paper_claim(fig3):
    """Paper abstract: 'a 30% reduction in imbalance'."""
    tf, _, _, ecmp, (_, paths) = fig3
    assert T.fim(ecmp.paths, tf) - T.fim(paths, tf) >= 15.0


def test_hop_greedy_fim(assignments, setups):
    _, (tf, _) = setups["paper"]
    _, (_, paths) = assignments["paper", "hop_greedy"]
    assert T.fim(paths, tf) == 25.0


@pytest.mark.parametrize("seed", range(5))
def test_static_beats_ecmp(fig3, seed):
    tf, twl, tfl, _, (_, static_paths) = fig3
    e = T.FlowTracer(tf, T.EcmpRouting(tf, seed=seed), twl, tfl).trace()
    assert T.fim(e.paths, tf) > T.fim(static_paths, tf) + 10.0


def test_throughput_spread(fig3):
    """ECMP against static by the port's Monte-Carlo engine on the CPU,
    anchored to the tracer and the scalar model at the reference seed."""
    tf, _, tfl, ecmp, _ = fig3
    mc = T.monte_carlo_throughput(tf, tfl, [7, 11, 42], hash_backend="exact",
                                  device="cpu")
    assert tuple(mc.per_pair.shape) == (16, 3)
    assert float(mc.per_pair.min()) < 350.0
    assert float(mc.per_pair.max()) <= 400.0 + 1e-6
    vec = mc.pair_throughput_for_seed(0)
    for pair, rate in T.per_pair_throughput(tfl, ecmp.paths).items():
        assert vec[pair] == pytest.approx(rate, rel=1e-9)


def test_report_summary(fig3):
    tf, _, _, ecmp, _ = fig3
    rep = T.analyze_paths(ecmp.paths, tf)
    assert rep.total_flows == 256
    assert rep.aggregate_fim == 29.1015625
    assert set(rep.per_layer_fim) == {
        "host-to-leaf", "leaf-to-host", "leaf-to-spine", "spine-to-leaf"}
    assert "FIM" in rep.summary()
    assert rep.collisions, "ECMP must produce over-ideal links"
