"""The port's compiled tables, hash grids, ECMP walk, link counts and FIM
against the JAX package's numpy engine (the differential reference),
on the CPU: link ids bit for bit, counts exactly (unit demand) or to
1e-12 relative (byte demand, summed in another order), FIM to 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import vector_sim as RV  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import device as tdevice  # noqa: E402
from repro_torch.core import vector_sim as TV  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    ARRAY_FIELDS, compiled_from_arrays, flows_from_records,
)

CPU = "cpu"
BIG_SEEDS = [0, 7, 2**40 + 17, 2**63, 2**64 - 1]
SEEDS = BIG_SEEDS + list(range(100, 159))          # 64 seeds
FIELD_MODES = [R.FIELDS_5TUPLE, R.FIELDS_VXLAN, R.FIELDS_IP_PAIR]


def port_flows(flows):
    return flows_from_records(
        (f.flow_id, f.src, f.dst, f.tuple5.src_ip, f.tuple5.dst_ip,
         f.tuple5.src_port, f.tuple5.dst_port, f.tuple5.protocol, f.bytes)
        for f in flows)


def port_compiled(ref_comp):
    """The reference's compiled tables handed to the port as arrays."""
    fab = T.Fabric.from_json(ref_comp.fabric.to_json())
    return compiled_from_arrays(
        {k: getattr(ref_comp, k) for k in ARRAY_FIELDS}, fab,
        ref_comp.key_of_ip)


@pytest.fixture(scope="module")
def setups(paper_setup, multipod_small):
    """fabric name -> (reference compiled, reference flows)."""
    out = {}
    for name, (fab, _, flows) in (("paper", paper_setup),
                                  ("multipod", multipod_small)):
        out[name] = (R.compile_fabric(fab), flows)
    return out


def _bytes_flows():
    """Paper testbed flows with heterogeneous volumes (and one zero)."""
    wl = R.bipartite_pairs([R.server_name(i) for i in range(8)],
                           [R.server_name(8 + i) for i in range(8)],
                           flows_per_pair=4,
                           bytes_per_flow=[0, 1, 10, 1000, 2**20, 7, 3, 2**30])
    return R.synthesize_flows(wl, nic_ip=R.nic_ip, nics_per_server=2)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fabric", ["paper", "multipod"])
def test_compile_fabric_matches_reference(fabric, setups):
    ref, _ = setups[fabric]
    got = T.compile_fabric(T.Fabric.from_json(ref.fabric.to_json()))
    for k in ARRAY_FIELDS:
        a, b = getattr(ref, k), getattr(got, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("device_names", "device_id", "layer_names", "key_of_ip",
              "nic_indices"):
        assert getattr(ref, k) == getattr(got, k), k
    assert [ln.name for ln in ref.links] == [ln.name for ln in got.links]


def test_compiled_from_arrays_round_trips(setups):
    ref, _ = setups["multipod"]
    comp = port_compiled(ref)
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(comp, k), getattr(ref, k))
    assert comp.nic_indices == ref.nic_indices
    tabs = comp.to(torch.device(CPU))
    assert comp.to(torch.device(CPU)) is tabs          # uploaded once
    np.testing.assert_array_equal(tabs.cand.numpy(),
                                  ref.cand.reshape(-1).astype(np.int64))
    with pytest.raises(ValueError):
        compiled_from_arrays({**{k: getattr(ref, k) for k in ARRAY_FIELDS},
                              "cand_n": ref.cand_n[:-1]},
                             comp.fabric, ref.key_of_ip)


@pytest.mark.parametrize("mode", FIELD_MODES)
def test_flow_fields_matrix_matches(mode, paper_setup):
    _, _, flows = paper_setup
    want = R.flow_fields_matrix(flows, mode)
    got = T.flow_fields_matrix(port_flows(flows), mode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# hash grids
# ---------------------------------------------------------------------------


def test_exact_grid_matches_numpy_splitmix():
    rng = np.random.default_rng(0)
    fields = rng.integers(0, 2**64 - 1, (50, 5), dtype=np.uint64)
    dev_seed = rng.integers(0, 2**64 - 1, (50, 16), dtype=np.uint64)
    dev_seed[0, :5] = np.array(BIG_SEEDS, np.uint64)
    want = RV.ecmp_hash_vec(fields, dev_seed)
    got = TV.ecmp_hash_grid(torch.from_numpy(fields.view(np.int64)),
                            torch.from_numpy(dev_seed.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_unsigned_modulo_matches_numpy():
    rng = np.random.default_rng(1)
    h = rng.integers(0, 2**64 - 1, 4000, dtype=np.uint64)
    h[:3] = [2**63, 2**64 - 1, 2**63 - 1]
    n = rng.integers(1, 40, 4000).astype(np.int64)
    got = TV._umod(torch.from_numpy(h.view(np.int64)), torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(),
                                  (h % n.astype(np.uint64)).astype(np.int64))


def test_normalize_seeds_masks_to_64_bits():
    got = T.normalize_seeds([2**64 + 5, -1, 2**63])
    np.testing.assert_array_equal(got, RV.normalize_seeds([2**64 + 5, -1,
                                                           2**63]))


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", [RV.EXACT, RV.MURMUR])
@pytest.mark.parametrize("mode", FIELD_MODES)
@pytest.mark.parametrize("fabric", ["paper", "multipod"])
def test_walk_bit_identical_to_numpy_engine(fabric, mode, backend, setups):
    ref_comp, flows = setups[fabric]
    want = R.simulate_paths(ref_comp, flows, SEEDS, fields=mode,
                            hash_backend=backend, engine="numpy").link_ids
    got = T.simulate_paths(port_compiled(ref_comp), port_flows(flows), SEEDS,
                           fields=mode, hash_backend=backend, device=CPU)
    assert got.link_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.link_ids.numpy(), want)
    np.testing.assert_array_equal(got.seeds, RV.normalize_seeds(SEEDS))


def test_cell_salt_matches_numpy_walk(setups):
    ref_comp, flows = setups["paper"]
    comp = port_compiled(ref_comp)
    fm = R.flow_fields_matrix(flows, R.FIELDS_5TUPLE)
    ends = ref_comp.flow_endpoint_ids(flows)
    seeds = RV.normalize_seeds(SEEDS)
    plain = T.ecmp_walk(comp, *ends, fm, seeds, hash_backend=RV.EXACT,
                        device=CPU)
    zero = T.ecmp_walk(comp, *ends, fm, seeds, hash_backend=RV.EXACT,
                       cell_salt=np.zeros((len(flows), len(seeds)), np.uint64),
                       device=CPU)
    assert torch.equal(plain, zero)
    salt = np.random.default_rng(2).integers(
        0, 2**64 - 1, (len(flows), len(seeds)), dtype=np.uint64)
    want = RV.ecmp_walk(ref_comp, *ends, fm, seeds, hash_backend=RV.EXACT,
                        cell_salt=salt)
    got = T.ecmp_walk(comp, *ends, fm, seeds, hash_backend=RV.EXACT,
                      cell_salt=salt, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, plain)


def test_max_hops_error_matches_reference(setups):
    ref_comp, flows = setups["paper"]
    with pytest.raises(RuntimeError) as want:
        R.simulate_paths(ref_comp, flows, [1], max_hops=1)
    with pytest.raises(RuntimeError) as got:
        T.simulate_paths(port_compiled(ref_comp), port_flows(flows), [1],
                         max_hops=1, device=CPU)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# counts and FIM
# ---------------------------------------------------------------------------


def test_counts_exact_under_uniform_demand(setups):
    ref_comp, flows = setups["paper"]
    want = R.simulate_paths(ref_comp, flows, SEEDS).link_flow_counts()
    got = T.simulate_paths(port_compiled(ref_comp), port_flows(flows), SEEDS,
                           device=CPU).link_flow_counts()
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_counts_close_under_byte_demand(paper_compiled):
    flows = _bytes_flows()
    want = R.simulate_paths(paper_compiled, flows, SEEDS,
                            demand_mode="bytes").link_flow_counts()
    got = T.simulate_paths(port_compiled(paper_compiled), port_flows(flows),
                           SEEDS, demand_mode="bytes",
                           device=CPU).link_flow_counts()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("only_used", [False, True])
@pytest.mark.parametrize("demand", ["uniform", "bytes"])
def test_fim_matches_reference(demand, only_used, paper_compiled):
    flows = _bytes_flows()
    want = R.monte_carlo_fim(paper_compiled, flows, SEEDS, demand_mode=demand,
                             only_used_leaves=only_used)
    got = T.monte_carlo_fim(port_compiled(paper_compiled), port_flows(flows),
                            SEEDS, demand_mode=demand,
                            only_used_leaves=only_used, device=CPU)
    np.testing.assert_allclose(got.aggregate.numpy(), want.aggregate,
                               rtol=1e-12, atol=0)
    assert list(got.per_layer) == list(want.per_layer)
    for layer, v in want.per_layer.items():
        np.testing.assert_allclose(got.per_layer[layer].numpy(), v,
                                   rtol=1e-12, atol=0, err_msg=layer)


def test_fim_layer_selection_matches_reference(setups):
    ref_comp, flows = setups["multipod"]
    layers = ["leaf-to-spine", "no-such-layer"]
    want = R.monte_carlo_fim(ref_comp, flows, SEEDS, layers=layers,
                             only_used_leaves=True)
    got = T.monte_carlo_fim(port_compiled(ref_comp), port_flows(flows), SEEDS,
                            layers=layers, only_used_leaves=True, device=CPU)
    assert list(got.per_layer) == ["leaf-to-spine"]
    np.testing.assert_allclose(got.aggregate.numpy(), want.aggregate,
                               rtol=1e-12, atol=0)


def test_monte_carlo_fim_summary_matches_reference(paper_setup,
                                                   paper_compiled):
    _, wl, _ = paper_setup
    twl = T.WorkloadDescription(pairs=[T.PairSpec(p.src, p.dst, p.num_flows)
                                       for p in wl.pairs])
    want = R.monte_carlo_fim(paper_compiled, wl, np.arange(64)).summary()
    got = T.monte_carlo_fim(port_compiled(paper_compiled), twl,
                            np.arange(64), device=CPU).summary()
    assert list(got) == list(want)
    for row, stats in want.items():
        for k, v in stats.items():
            assert got[row][k] == pytest.approx(v, rel=1e-12, abs=1e-12), \
                (row, k)


def test_seed_chunking_never_changes_fim(setups, monkeypatch):
    ref_comp, flows = setups["multipod"]
    comp, tflows = port_compiled(ref_comp), port_flows(flows)
    whole = T.monte_carlo_fim(comp, tflows, SEEDS, device=CPU)
    assert whole.seed_chunk == len(SEEDS)
    for chunk in (1, 7):
        monkeypatch.setattr(TV, "seed_chunk_size", lambda *a, c=chunk: c)
        part = T.monte_carlo_fim(comp, tflows, SEEDS, device=CPU)
        assert part.seed_chunk == chunk
        assert torch.equal(part.aggregate, whole.aggregate)
        for layer, v in whole.per_layer.items():
            assert torch.equal(part.per_layer[layer], v)


def test_default_seed_chunk_covers_small_sweeps_on_cpu():
    assert T.seed_chunk_size(256, 1024, TV.WALK_BYTES_PER_CELL,
                             torch.device(CPU)) == 1024
    assert T.seed_chunk_size(10**9, 8, TV.WALK_BYTES_PER_CELL,
                             torch.device(CPU)) == 1


# ---------------------------------------------------------------------------
# the device policy and the spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["simulate_paths", "monte_carlo_fim",
                                   "monte_carlo_throughput"])
def test_entry_points_run_on_the_card_unless_asked(entry, setups,
                                                   monkeypatch):
    """With no device= the entry points want the card; on a host without
    one they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref_comp, flows = setups["paper"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(T, entry)(port_compiled(ref_comp), port_flows(flows), [1])


def test_resolve_device_policy(monkeypatch):
    assert tdevice.resolve_device(CPU) == torch.device(CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda:0")


def test_hash_backend_follows_the_device():
    assert TV.resolve_hash_backend(None, torch.device("cuda")) == T.MURMUR
    assert TV.resolve_hash_backend(None, torch.device(CPU)) == T.EXACT
    assert TV.resolve_hash_backend(T.EXACT, torch.device("cuda")) == T.EXACT
    with pytest.raises(ValueError):
        TV.resolve_hash_backend("crc", torch.device(CPU))


def test_spec_resolves_and_rejects():
    s = T.SimSpec(device=CPU, strategy="ecmp", transport="roce-nack").resolve()
    assert s.device == torch.device(CPU) and s.hash_backend == T.EXACT
    assert s.transport is T.ROCE_NACK
    assert type(s.strategy) is T.EcmpStrategy and TV._is_plain_ecmp(s.strategy)
    assert s.resolve() == s
    with pytest.raises(ValueError, match="registered"):
        T.SimSpec(device=CPU, strategy="no-such-strategy").resolve()
    with pytest.raises(ValueError):
        T.SimSpec(device=CPU, fields="mac").resolve()
    with pytest.raises(ValueError):
        TV.resolve_spec(T.SimSpec(device=CPU), {"max_hops": 3})


def test_generator_is_seeded_explicitly():
    a = torch.rand(4, generator=tdevice.generator(5, CPU))
    b = torch.rand(4, generator=tdevice.generator(5, CPU))
    assert torch.equal(a, b)
