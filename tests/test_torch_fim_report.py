"""The port's scalar Path Analyzer metrics (``core/fim.py``) and path
report (``core/report.py``) against the JAX package's, on the CPU.

The cases of ``tests/test_fim.py`` run here as parametrised cases on
both packages' line and chain fabrics, and the metrics of traced paths
(the paper testbed and the small multipod fabric, each package tracing
its own) must equal the reference's: the port keeps the reference's
float operations in the same order, so values compare with ``==``."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.core.fabric as RF  # noqa: E402
from repro.core.fim import layer_load_stats as r_layer_load_stats  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.fabric as TF  # noqa: E402
from repro_torch.core.fim import layer_load_stats  # noqa: E402
from repro_torch.interop import flows_from_records  # noqa: E402

PACKAGES = {"ref": (R, RF), "port": (T, TF)}
# count vectors of the property cases: drawn once from a seeded rng
_rng = np.random.default_rng(0)
COUNTS = [[int(c) for c in _rng.integers(0, 51, _rng.integers(2, 33))]
          for _ in range(12)] + [[0, 7], [5, 0, 0, 0], [1, 2, 3, 4, 5]]


def line_fabric(fab_mod, n_links):
    """One layer of n parallel links between two devices."""
    devices = [fab_mod.Device("a", fab_mod.LEAF),
               fab_mod.Device("b", fab_mod.SERVER)]
    links = [fab_mod.Link("a", f"p{i}", "b", f"q{i}", 100.0, "layer")
             for i in range(n_links)]
    return fab_mod.Fabric(devices, links)


def chain_fabric(fab_mod, n_layers, n_links):
    """A chain a -> h0 -> ... -> b with n parallel links per stage."""
    names = ["a"] + [f"h{i}" for i in range(n_layers - 1)] + ["b"]
    devices = ([fab_mod.Device(n, fab_mod.LEAF) for n in names[:-1]]
               + [fab_mod.Device(names[-1], fab_mod.SERVER)])
    links = [fab_mod.Link(names[s], f"p{s}-{i}", names[s + 1], f"q{s}-{i}",
                          100.0, f"L{s}")
             for s in range(n_layers) for i in range(n_links)]
    return fab_mod.Fabric(devices, links)


def paths_from_counts(fab, counts):
    paths, fid = {}, 0
    for link, c in zip(fab.links, counts):
        for _ in range(c):
            paths[fid] = [link]
            fid += 1
    return paths


def both(build):
    """``build(core, fabric_module)`` under each package: (ref, port)."""
    return tuple(build(*PACKAGES[k]) for k in ("ref", "port"))


# ---------------------------------------------------------------------------
# the cases of tests/test_fim.py, on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counts", COUNTS)
def test_fim_matches_mape_formula_and_reference(counts):
    def run(core, fab_mod):
        fab = line_fabric(fab_mod, len(counts))
        return core.fim(paths_from_counts(fab, counts), fab)

    want, got = both(run)
    assert got == want
    if sum(counts):
        n, ideal = len(counts), sum(counts) / len(counts)
        assert got == pytest.approx(
            100.0 / n * sum(abs(c - ideal) / ideal for c in counts), rel=1e-9)
    else:
        assert got == 0.0


@pytest.mark.parametrize("per_link,n_links", [(1, 2), (3, 5), (20, 16),
                                              (7, 9)])
def test_fim_zero_iff_balanced(per_link, n_links):
    fab = line_fabric(TF, n_links)
    assert T.fim(paths_from_counts(fab, [per_link] * n_links), fab) == \
        pytest.approx(0.0, abs=1e-12)
    skewed = [per_link] * n_links
    skewed[0] += 1
    assert T.fim(paths_from_counts(fab, skewed), fab) > 0.0


@pytest.mark.parametrize("counts", COUNTS[:8])
def test_fim_permutation_and_scale_invariant(counts):
    assert sum(counts) > 0
    fab = line_fabric(TF, len(counts))
    f1 = T.fim(paths_from_counts(fab, counts), fab)
    perm = [int(c) for c in np.random.default_rng(0).permutation(counts)]
    assert f1 >= 0
    assert T.fim(paths_from_counts(fab, perm), fab) == pytest.approx(
        f1, rel=1e-9)
    for k in (2, 5):
        assert T.fim(paths_from_counts(fab, [c * k for c in counts]),
                     fab) == pytest.approx(f1, rel=1e-9)


def test_per_layer_drops_idle_layers():
    def run(core, fab_mod):
        fab = line_fabric(fab_mod, 4)
        return core.per_layer_fim(paths_from_counts(fab, [1, 1, 1, 1]), fab,
                                  layers=["layer", "nonexistent"])

    want, got = both(run)
    assert got == want and list(got) == ["layer"]


def test_only_used_leaves_filters_idle_devices():
    def run(core, fab_mod):
        fab = chain_fabric(fab_mod, 1, 3)
        extra = fab_mod.Fabric(
            list(fab.devices.values()) + [fab_mod.Device("idle",
                                                         fab_mod.LEAF)],
            fab.links + [fab_mod.Link("a", "px", "idle", "qx", 100.0,
                                      "layer_idle")])
        paths = {0: [extra.links[0]], 1: [extra.links[1]]}
        return (core.per_layer_fim(paths, extra, only_used_leaves=True),
                core.fim(paths, extra, only_used_leaves=True))

    want, got = both(run)
    assert got == want
    assert set(got[0]) == {"L0"} and got[0]["L0"][1] == 3


class CountingPaths(dict):
    """Mapping that counts ``.values()`` traversals."""

    def __init__(self, *a):
        super().__init__(*a)
        self.values_calls = 0

    def values(self):
        self.values_calls += 1
        return super().values()


def test_per_layer_fim_scans_paths_once():
    n_layers = 6
    fab = chain_fabric(TF, n_layers, 2)
    paths = CountingPaths(
        {fid: [fab.links[s * 2] for s in range(n_layers)] for fid in range(4)})
    assert len(T.per_layer_fim(paths, fab, only_used_leaves=True)) == n_layers
    assert paths.values_calls <= 3, paths.values_calls


@pytest.mark.parametrize("n_flows", [1, 2, 3, 7, 16])
def test_throughput_equal_share_single_link(n_flows):
    def run(core, fab_mod):
        fab = line_fabric(fab_mod, 1)
        return core.max_min_throughput({i: [fab.links[0]]
                                        for i in range(n_flows)})

    want, got = both(run)
    assert got == want
    assert all(r == pytest.approx(100.0 / n_flows) for r in got.values())


@pytest.mark.parametrize("counts", [[1, 1], [3, 1, 8], [8, 7, 6, 5, 4, 3, 2],
                                    [2, 5]])
def test_throughput_conservation(counts):
    """Max-min on dedicated links saturates each exactly."""
    def run(core, fab_mod):
        fab = line_fabric(fab_mod, len(counts))
        paths = paths_from_counts(fab, counts)
        return paths, core.max_min_throughput(paths)

    (_, want), (paths, got) = both(run)
    assert got == want
    per_link = {}
    for fid, p in paths.items():
        per_link[p[0].name] = per_link.get(p[0].name, 0.0) + got[fid]
    assert all(t == pytest.approx(100.0) for t in per_link.values())


def test_max_min_over_an_unused_path_is_unbounded():
    """A flow crossing no link gets an infinite rate, as in the reference."""
    def run(core, fab_mod):
        fab = line_fabric(fab_mod, 1)
        return core.max_min_throughput({0: [], 1: [fab.links[0]]})

    want, got = both(run)
    assert got == want == {1: 100.0, 0: float("inf")}


def test_layer_load_stats_consistent_with_per_layer_fim():
    fab = line_fabric(TF, 4)
    paths = paths_from_counts(fab, [5, 1, 1, 1])
    stats = layer_load_stats(paths, fab)
    assert set(stats) == set(T.per_layer_fim(paths, fab))
    s = stats["layer"]
    assert (s.total, s.n_links, s.ideal) == (8, 4, 2.0)
    assert s.fim_pct == T.per_layer_fim(paths, fab)["layer"][0]
    assert set(s.link_counts) == {ln.name for ln in fab.links}
    assert sum(s.link_counts.values()) == s.total
    assert isinstance(s, T.LayerLoadStats)


def test_layer_load_stats_guards_empty_and_idle_layers():
    fab = line_fabric(TF, 3)
    paths = paths_from_counts(fab, [2, 1, 0])
    assert layer_load_stats(paths, fab, layers=["no-such-layer"]) == {}
    assert layer_load_stats({}, fab) == {}
    assert T.fim({}, fab) == 0.0


def test_analyze_paths_single_sourced_from_layer_stats():
    def run(core, fab_mod):
        fab = line_fabric(fab_mod, 4)
        return core.analyze_paths(paths_from_counts(fab, [6, 2, 0, 0]), fab)

    want, got = both(run)
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    fab = line_fabric(TF, 4)
    stats = layer_load_stats(paths_from_counts(fab, [6, 2, 0, 0]), fab)
    assert got.per_layer == {k: s.link_counts for k, s in stats.items()}
    assert got.collisions == [("a:p0->b:q0", 6)]


# ---------------------------------------------------------------------------
# traced paths: the paper testbed and the small multipod fabric
# ---------------------------------------------------------------------------


def port_flows(flows):
    return flows_from_records(
        (f.flow_id, f.src, f.dst, f.tuple5.src_ip, f.tuple5.dst_ip,
         f.tuple5.src_port, f.tuple5.dst_port, f.tuple5.protocol, f.bytes)
        for f in flows)


@pytest.fixture(scope="module")
def traced(paper_setup, multipod_small):
    """(fabric, seed) -> ((ref fabric, flows, paths), (the port's)): each
    package traces its own copy of the same inputs."""
    out = {}
    for name, (fab, wl, flows) in (("paper", paper_setup),
                                   ("multipod", multipod_small)):
        tfab = T.Fabric.from_json(fab.to_json())
        tflows = port_flows(flows)
        twl = T.workload_from_flows(tflows)
        rwl = R.workload_from_flows(flows)
        for seed in (3, 7, 2**40 + 17):
            ref = R.FlowTracer(fab, R.EcmpRouting(fab, seed=seed), rwl,
                               flows).trace()
            got = T.FlowTracer(tfab, T.EcmpRouting(tfab, seed=seed), twl,
                               tflows).trace()
            out[name, seed] = ((fab, flows, ref.paths),
                               (tfab, tflows, got.paths))
    return out


CASES = [(f, s) for f in ("paper", "multipod") for s in (3, 7, 2**40 + 17)]


@pytest.mark.parametrize("case", CASES)
def test_traced_fim_equals_reference(traced, case):
    (rf, _, rp), (tf, _, tp) = traced[case]
    assert T.fim(tp, tf) == R.fim(rp, rf)
    assert T.per_layer_fim(tp, tf) == R.per_layer_fim(rp, rf)
    assert T.link_flow_counts(tp) == R.link_flow_counts(rp)
    layers = tf.layers[:2]
    assert T.fim(tp, tf, layers=layers) == R.fim(rp, rf, layers=layers)
    for used in (False, True):
        got = layer_load_stats(tp, tf, only_used_leaves=used)
        want = r_layer_load_stats(rp, rf, only_used_leaves=used)
        assert {k: dataclasses.asdict(s) for k, s in got.items()} == {
            k: dataclasses.asdict(s) for k, s in want.items()}
        assert T.fim(tp, tf, only_used_leaves=used) == R.fim(
            rp, rf, only_used_leaves=used)


@pytest.mark.parametrize("case", CASES)
def test_traced_throughput_equals_reference(traced, case):
    (_, rfl, rp), (_, tfl, tp) = traced[case]
    assert T.max_min_throughput(tp) == R.max_min_throughput(rp)
    got = T.per_pair_throughput(tfl, tp)
    want = R.per_pair_throughput(rfl, rp)
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("case", CASES)
def test_traced_report_equals_reference(traced, case):
    (rf, _, rp), (tf, _, tp) = traced[case]
    got, want = T.analyze_paths(tp, tf), R.analyze_paths(rp, rf)
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    assert got.collisions, "ECMP must produce over-ideal links"


def test_paper_testbed_seed7_values(traced):
    """The paper testbed's ECMP imbalance at the reference seed, which
    ``chip_smoke.py`` pins for its fig3 phase."""
    _, (tf, tfl, tp) = traced["paper", 7]
    assert T.fim(tp, tf) == 29.1015625
    assert {k: v for k, (v, _) in T.per_layer_fim(tp, tf).items()} == {
        "host-to-leaf": 30.46875, "leaf-to-host": 19.53125,
        "leaf-to-spine": 33.59375, "spine-to-leaf": 32.8125}
    tp_pairs = T.per_pair_throughput(tfl, tp)
    assert min(tp_pairs.values()) == 268.7686011904762
    assert max(tp_pairs.values()) == 348.86780753968253
