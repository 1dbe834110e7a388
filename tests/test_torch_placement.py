"""The sequential congestion-aware placement chain (``kernels/placement``)
against the JAX package's host loop, on the CPU.

The wrapper's plain version must give the reference's
``_sequential_congestion_place`` bit for bit: the same link ids, the same
float64 load tally (sums in flow order, any weights) and the same hop
count, with or without committed loads and a residue mask, under both
hash backends.  The card's kernel is held against this plain version in
``test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import strategies as RS  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels.placement import ops  # noqa: E402
from repro_torch.kernels.placement import ref as placement_ref  # noqa: E402
from test_torch_gpu import MAX_HOPS, placement_case, port_place  # noqa: E402
from test_torch_sim import port_compiled, port_flows  # noqa: E402

@pytest.fixture(scope="module")
def paper(paper_setup, paper_compiled):
    _, _, flows = paper_setup
    return (paper_compiled, flows, port_compiled(paper_compiled),
            port_flows(flows), R.flow_fields_matrix(flows, "5tuple"))


@pytest.mark.parametrize("backend", ["exact", "murmur"])
@pytest.mark.parametrize("weights", ["unit", "random"])
@pytest.mark.parametrize("masked,preload", [(False, False), (True, True)])
def test_plain_version_is_the_reference_chain(paper, backend, weights,
                                              masked, preload):
    ref_comp, rflows, comp, tflows, fm = paper
    case = placement_case(comp, tflows, fm, 8, weights, masked, preload,
                          np.random.default_rng(7))
    _, seeds, w, order, load, mask, ids = case
    load_r, ids_r = load.copy(), ids.copy()
    want = RS._sequential_congestion_place(
        ref_comp, rflows, fm, seeds, ref_comp.flow_endpoint_ids(rflows), w,
        order, load_r, ids_r, hash_backend=backend, max_hops=MAX_HOPS,
        mask=mask)
    ops.reset_launches()
    hops, fault, got_ids, got_load = port_place(comp, tflows, case, backend)
    assert ops.LAUNCHES == {"congestion_place": 0}
    assert fault is None and hops == want
    np.testing.assert_array_equal(got_ids.numpy(), ids_r)
    assert np.array_equal(got_load.numpy(), load_r)     # bit for bit


@pytest.mark.parametrize("strategy", ["congestion-aware",
                                      "wave-congestion-aware"])
def test_a_walk_cut_short_names_the_reference_flow(paper, strategy):
    """At two hops the cross-rack flows cannot arrive: the port raises
    the reference's error, for the first flow in placement order."""
    ref_comp, rflows, comp, tflows, _ = paper
    with pytest.raises(RuntimeError) as want:
        R.simulate_paths(ref_comp, rflows, np.arange(4), strategy=strategy,
                         max_hops=2)
    with pytest.raises(RuntimeError) as got:
        T.simulate_paths(comp, tflows, np.arange(4), strategy=strategy,
                         max_hops=2, device="cpu")
    assert str(got.value) == str(want.value)


def test_wrapper_checks_its_inputs(paper):
    _, _, comp, tflows, fm = paper
    case = placement_case(comp, tflows, fm, 2, "unit", False, False,
                          np.random.default_rng(1))
    fm_, seeds, w, order, load, mask, ids = case
    with pytest.raises(TypeError):
        port_place(comp, tflows, (fm_, seeds, w.astype(np.float32), order,
                                  load, mask, ids), "murmur")
    with pytest.raises(ValueError):
        port_place(comp, tflows, (fm_, seeds, w, order, load, mask,
                                  ids[:4]), "murmur")


@pytest.fixture(scope="module")
def fabrics(paper):
    """The compiled paper testbed, the default multipod fabric and one
    whose compact tables exceed a block's shared memory."""
    return {"paper": paper[2],
            "multipod": T.compile_fabric(T.build_multipod_fabric()),
            "multipod-3": T.compile_fabric(
                T.build_multipod_fabric(num_pods=3))}


@pytest.mark.parametrize("name", ["paper", "multipod"])
def test_compact_tables_reproduce_the_candidate_rows(fabrics, name):
    comp = fabrics[name]
    tabs = comp.to("cpu")
    row_off, ids = ops.compact_candidates(tabs.cand, tabs.cand_n,
                                          tabs.c_max)
    row_off, ids = row_off.numpy(), ids.numpy()
    V, K, C = comp.cand.shape
    assert row_off[0] == 0 and row_off[-1] == ids.size
    for v in range(V):
        for k in range(K):
            n = int(comp.cand_n[v, k])
            got = ids[row_off[v * K + k]:row_off[v * K + k + 1]]
            np.testing.assert_array_equal(got, comp.cand[v, k, :n])
    # the packed tables hold the same sections at their offsets
    blob, offs = ops.pack_tables(tabs.cand, tabs.cand_n, tabs.dev_crc,
                                 tabs.is_server, tabs.link_dst, C)
    b = blob.numpy()
    L = comp.num_links

    def section(name, dtype, count):
        at = offs[name]
        return b[at:at + count * np.dtype(dtype).itemsize].view(dtype)

    assert blob.numel() % 16 == 0 and offs["n_cands"] == ids.size
    np.testing.assert_array_equal(section("crc", np.uint64, V), comp.dev_crc)
    np.testing.assert_array_equal(section("lcrc", np.uint64, L),
                                  comp.dev_crc[comp.link_dst])
    np.testing.assert_array_equal(section("row", np.int32, V * K + 1),
                                  row_off)
    np.testing.assert_array_equal(section("cand", np.int16, ids.size), ids)
    nxt = section("next", np.int16, L).astype(np.int64)
    np.testing.assert_array_equal(nxt >> 1, comp.link_dst)
    np.testing.assert_array_equal((nxt & 1).astype(bool),
                                  comp.is_server[comp.link_dst])


def test_plan_stages_the_tables_where_they_fit(fabrics):
    """The default multipod fabric's compact tables (about 150 KB) sit in
    shared memory beside ``WARPS`` load rows of 8 KB; three pods' do not,
    and take the instance that reads them from global memory with as
    many rows.  A row that cannot fit at all raises."""
    def plan_of(comp):
        tabs = comp.to("cpu")
        _, offs = ops.pack_tables(tabs.cand, tabs.cand_n, tabs.dev_crc,
                                  tabs.is_server, tabs.link_dst, tabs.c_max)
        return ops.plan(comp.num_links, comp.num_devices,
                        tabs.cand_n.numel(), offs["n_cands"])

    big = plan_of(fabrics["multipod"])
    assert big == ops.Plan(True, ops.WARPS, big.smem_bytes)
    assert 8 * ops.WARPS * 1024 + 150_000 < big.smem_bytes <= ops.SMEM_BUDGET
    huge = plan_of(fabrics["multipod-3"])
    assert not huge.shared_tables and huge.warps == ops.WARPS
    assert huge.smem_bytes == ops.WARPS * (8 * 1536 + ops.FIELD_BYTES)
    assert plan_of(fabrics["paper"]).shared_tables
    assert ops.plan(20_000, 100, 10, 10) == ops.Plan(
        False, 1, 160_000 + ops.FIELD_BYTES)
    with pytest.raises(ValueError):
        ops.plan(30_000, 100, 10, 10)


def kernel_model(comp, tflows, case, backend, max_hops=MAX_HOPS):
    """The kernel's walk in numpy over exactly what the wrapper hands it
    (the packed tables and the per-flow inputs in placement order), a
    seed at a time; returns (link ids, loads) like ``port_place``."""
    fm, seeds, w, order, load, mask, ids = case
    tabs = comp.to("cpu")
    blob, offs = ops.pack_tables(tabs.cand, tabs.cand_n, tabs.dev_crc,
                                 tabs.is_server, tabs.link_dst, tabs.c_max)
    b = blob.numpy()
    crc = b[offs["crc"]:offs["lcrc"]].view(np.uint64)
    row_off = b[offs["row"]:offs["next"]].view(np.int32)
    nxt = b[offs["next"]:offs["cand"]].view(np.int16)
    cand = b[offs["cand"]:].view(np.int16)
    ends_t = [torch.from_numpy(np.asarray(e, np.int64))
              for e in comp.flow_endpoint_ids(tflows)]
    ends, w_o, f_o, sel, sel_off = ops.chain_inputs(
        tabs.is_server, torch.from_numpy(fm.view(np.int64).copy()), *ends_t,
        torch.from_numpy(w), torch.from_numpy(order),
        None if mask is None else torch.from_numpy(mask))
    ends, w_o, f_o = ends.numpy(), w_o.numpy(), f_o.numpy().view(np.uint64)
    ids, load = ids.copy(), load.copy()
    n, K = len(tflows), tabs.num_keys
    for s, seed in enumerate(seeds):
        items = (range(n) if sel is None else
                 sel.numpy()[sel_off[s]:sel_off[s + 1]])
        for pos in items:
            src, dst, key0, dkey = (int(e) for e in ends[pos])
            state, key, done, path = src, key0, False, []
            while len(path) < max_hops and not done:
                vk = state * K + key
                cds = cand[row_off[vk]:row_off[vk + 1]].astype(np.int64)
                vals = np.where(cds >= 0, load[s, np.maximum(cds, 0)], np.nan)
                link = -1
                if not np.isnan(vals).all():
                    ties = cds[vals == np.nanmin(vals)]
                    rank = 0
                    if len(ties) > 1:
                        h = placement_ref.flow_hash(
                            f_o[pos:pos + 1],
                            np.array([[crc[state] ^ seed]], np.uint64),
                            backend == "murmur")[0, 0]
                        rank = int(h % np.uint64(len(ties)))
                    link = int(ties[rank])
                path.append(link)
                if link >= 0:
                    state, done = int(nxt[link]) >> 1, bool(nxt[link] & 1)
                else:
                    done = True
                key = dkey
            assert done and state == dst
            ids[:len(path), order[pos], s] = path
            for link in path:
                if link >= 0:
                    load[s, link] += w_o[pos]
    return ids, load


@pytest.mark.parametrize("backend", ["exact", "murmur"])
@pytest.mark.parametrize("weights", ["unit", "random"])
@pytest.mark.parametrize("masked,preload", [(False, False), (True, True)])
def test_kernel_inputs_walk_to_the_plain_versions_paths(paper, backend,
                                                        weights, masked,
                                                        preload):
    """The packed tables, the next-device codes, the first and later
    hops' keys and the seeds' position lists that the wrapper hands the
    kernel carry the plain version's chain: walking them as the kernel
    does gives its link ids and loads bit for bit."""
    _, _, comp, tflows, fm = paper
    case = placement_case(comp, tflows, fm, 3, weights, masked, preload,
                          np.random.default_rng(11))
    want = port_place(comp, tflows, case, backend)
    got_ids, got_load = kernel_model(comp, tflows, case, backend)
    np.testing.assert_array_equal(got_ids, want[2].numpy())
    assert np.array_equal(got_load, want[3].numpy())
