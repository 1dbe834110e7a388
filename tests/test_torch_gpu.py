"""The port on the card against the port on the CPU.

Every test here needs a CUDA card and skips (from inside the test) on a
host without one.  They import neither ``jax`` nor the JAX package's
kernels, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CPU side is held against the JAX package by the other
``test_torch_*`` files; here the card must give the same link ids bit
for bit, counts and FIM to 1e-12 and rates to 1e-9 relative (float
atomics on the card sum in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core import vector_throughput as TT  # noqa: E402
from repro_torch.kernels.flowhash import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu

SEEDS = [0, 7, 2**40 + 17, 2**63, 2**64 - 1] + list(range(100, 159))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def multipod():
    fab = T.build_multipod_fabric(num_pods=2, hosts_per_pod=8,
                                  leaves_per_pod=2, num_spines=4)
    wl = T.bipartite_pairs([f"host-{i}" for i in range(8)],
                           [f"host-{8 + i}" for i in range(8)],
                           flows_per_pair=4,
                           bytes_per_flow=[1, 5, 10, 2**20, 0, 3, 9, 2**30])
    flows = T.synthesize_flows(wl, nic_ip=T.nic_ip, nics_per_server=1)
    return T.compile_fabric(fab), flows


def test_kernel_matches_plain_version(card):
    rng = np.random.default_rng(1)
    f = torch.from_numpy(rng.integers(0, 2**40, (3000, 5))).to(card)
    sd = torch.from_numpy(rng.integers(0, 2**62, (3000, 257))).to(card)
    ops.reset_launches()
    got = ops.murmur_hash_grid(f, sd)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.murmur_hash_grid_ref(f, sd))
    init = torch.full_like(sd[:, :1], 5)
    assert torch.equal(ops.bulk_hash(f, 2**33 + 5),
                       ref.murmur_hash_grid_ref(f, init)[:, 0])
    assert ops.LAUNCHES == {"murmur_hash_grid": 1, "bulk_hash": 1}


def test_kernel_wrapper_raises_instead_of_falling_back(card):
    f = torch.zeros((4, 5), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        ops.murmur_hash_grid(f, torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.murmur_hash_grid(
            f, torch.zeros((3, 4), dtype=torch.int64, device=card).T)


@pytest.mark.parametrize("backend", ["exact", "murmur"])
def test_walk_on_card_equals_cpu(card, multipod, backend):
    comp, flows = multipod
    for mode in ("5tuple", "vxlan", "ip-pair"):
        want = T.simulate_paths(comp, flows, SEEDS, fields=mode,
                                hash_backend=backend, device="cpu")
        got = T.simulate_paths(comp, flows, SEEDS, fields=mode,
                               hash_backend=backend)
        assert got.link_ids.device.type == "cuda"
        assert torch.equal(got.link_ids.cpu(), want.link_ids), mode


@pytest.mark.parametrize("demand", ["uniform", "bytes"])
def test_fim_and_rates_on_card_equal_cpu(card, multipod, demand,
                                        monkeypatch):
    comp, flows = multipod
    kw = dict(hash_backend="exact", demand_mode=demand)
    want = T.monte_carlo_fim(comp, flows, SEEDS, only_used_leaves=True,
                             device="cpu", **kw)
    got = T.monte_carlo_fim(comp, flows, SEEDS, only_used_leaves=True, **kw)
    np.testing.assert_allclose(got.aggregate.cpu().numpy(),
                               want.aggregate.numpy(), rtol=1e-12, atol=0)
    want = T.monte_carlo_throughput(comp, flows, SEEDS, device="cpu", **kw)
    monkeypatch.setattr(TT, "seed_chunk_size", lambda *a: 9)  # 8 chunks
    got = T.monte_carlo_throughput(comp, flows, SEEDS, **kw)
    assert got.seed_chunk == 9
    np.testing.assert_allclose(got.rates.cpu().numpy(), want.rates.numpy(),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.per_pair.cpu().numpy(),
                               want.per_pair.numpy(), rtol=1e-9, atol=0)
