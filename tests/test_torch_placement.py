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
