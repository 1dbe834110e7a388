"""The port on the card against the port on the CPU.

Every test here needs a CUDA card and skips (from inside the test) on a
host without one.  They import neither ``jax`` nor the JAX package's
kernels, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CPU side is held against the JAX package by the other
``test_torch_*`` files; here the card must give the same link ids bit
for bit, counts and FIM to 1e-12 and rates to 1e-9 relative (float
atomics on the card sum in another order).  The flash-attention kernel
must match its plain version to 2e-6 in f32 and 2e-2 in bf16 (the JAX
package's tolerances for its Pallas kernel) and, row by row, to the
relative limits of ``ref.ROW_RTOL`` (1e-4 f32, 2e-2 bf16); the reduced
granite model on the card must match the CPU in f32 with TF32 off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import vector_throughput as TT  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flowhash import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu

SEEDS = [0, 7, 2**40 + 17, 2**63, 2**64 - 1] + list(range(100, 159))


FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the f32 plain versions and the f32 model are compared in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,hd", [(256, 64), (1000, 64), (333, 32),
                                  (515, 128)])
def test_flash_kernel_matches_plain_version(card, dtype, causal, S, hd):
    """GQA (8 query heads over 2 kv heads), ragged S, every head dim."""
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(card, dtype) for sh in
               ((2, 8, S, hd), (2, 2, S, hd), (2, 2, S, hd)))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {"flash_attention": 1}
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert float(fa_ref.row_errors(got, want).max()) <= fa_ref.ROW_RTOL[dtype]


def test_flash_kernel_reads_the_model_layout(card):
    """Transposed (B, S, H, hd) views go in as they are; the output comes
    back with q's strides."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(card, torch.bfloat16) for sh in
               ((1, 700, 8, 64), (1, 700, 2, 64), (1, 700, 2, 64)))
    got = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = fa_ref.flash_attention_ref(q.transpose(1, 2).contiguous(),
                                      k.transpose(1, 2).contiguous(),
                                      v.transpose(1, 2).contiguous())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert float(fa_ref.row_errors(got, want).max()) <= fa_ref.ROW_RTOL[
        torch.bfloat16]


def test_flash_launch_that_is_refused_raises(card):
    """65,536 (batch, head) pairs exceed the grid's y limit: the card
    refuses the launch and the wrapper raises instead of returning
    garbage."""
    q = torch.zeros((1, 65536, 1, 32), dtype=torch.bfloat16, device=card)
    k = torch.zeros((1, 1, 1, 32), dtype=torch.bfloat16, device=card)
    fa_ops.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa_ops.flash_attention(q, k, k)
    assert fa_ops.LAUNCHES == {"flash_attention": 0}


def test_flash_wrapper_raises_instead_of_falling_back(card):
    q = torch.zeros((1, 2, 16, 96), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 16, 72), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention(q[..., 4:68], q[..., 4:68], q[..., 4:68])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_model_and_serving_on_card_equal_cpu(card):
    """Reduced granite in f32: a 2,176-token prefill (the flash kernel,
    f32 route) and greedy generation (the cached decode) on the card
    against the CPU."""
    import dataclasses
    cfg = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), dtype="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg)
    params = cpu.init(0)
    params_gpu = _to(params, card)
    toks = torch.from_numpy(
        (np.arange(2 * 2176).reshape(2, 2176) * 7 % cfg.vocab))
    want = cpu.prefill(params, {"tokens": toks})
    fa_ops.reset_launches()
    got = gpu.prefill(params_gpu, {"tokens": toks.to(card)})
    assert fa_ops.LAUNCHES == {"flash_attention": cfg.num_layers}
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    prompt = toks[:, :5]
    want = ServeEngine(cpu, 2, 12).generate(params, prompt, steps=7)
    got = ServeEngine(gpu, 2, 12).generate(params_gpu, prompt, steps=7)
    assert torch.equal(got.cpu(), want)
