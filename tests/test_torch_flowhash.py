"""The port's murmur3 flow-hash ops against the JAX package's Pallas
kernels (run in interpret mode, as tests/test_kernels.py runs them) and
its numpy-engine murmur grid: bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.vector_sim import _murmur_hash_grid  # noqa: E402
from repro.kernels.flowhash import ops as jops  # noqa: E402
from repro_torch.kernels.flowhash import ops  # noqa: E402

N_ROWS = 5000            # not a multiple of the Pallas 4096-row block


def _fields(rng, n, f):
    return rng.integers(0, 2**32, (n, f), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n_fields", [2, 3, 5])
def test_bulk_hash_equals_pallas_kernel(n_fields):
    rng = np.random.default_rng(n_fields)
    fields = _fields(rng, N_ROWS, n_fields)
    seed = 2**31 + 977 * n_fields
    want = np.asarray(jops.bulk_hash(jnp.asarray(fields), seed,
                                     force_kernel=True, interpret=True))
    got = ops.bulk_hash(torch.from_numpy(fields.astype(np.int64)), seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n_fields", [2, 3, 5])
def test_bulk_hash_seeded_equals_pallas_kernel(n_fields):
    rng = np.random.default_rng(10 + n_fields)
    fields = _fields(rng, N_ROWS, n_fields)
    seeds = rng.integers(2**31, 2**32, N_ROWS, dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jops.bulk_hash_seeded(
        jnp.asarray(fields), jnp.asarray(seeds), force_kernel=True,
        interpret=True))
    got = ops.bulk_hash_seeded(torch.from_numpy(fields.astype(np.int64)),
                               torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [2**31, 2**32 - 1, 2**32 + 5, 2**40 + 7,
                                  -1, -2**31 - 3])
def test_bulk_hash_seed_wraps_like_the_jax_package(seed):
    """Seeds at and past 2**31, and negative ones, hash from their low 32
    bits, as the JAX package's ``bulk_hash`` wraps them."""
    rng = np.random.default_rng(17)
    fields = _fields(rng, 300, 5)
    want = np.asarray(jops.bulk_hash(jnp.asarray(fields), seed,
                                     force_kernel=True, interpret=True))
    got = ops.bulk_hash(torch.from_numpy(fields.astype(np.int64)), seed)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_bulk_hash_is_the_broadcast_seeded_hash():
    rng = np.random.default_rng(3)
    f = torch.from_numpy(_fields(rng, 300, 5).astype(np.int64))
    full = torch.full((300,), 2**31 + 7, dtype=torch.int64)
    assert torch.equal(ops.bulk_hash(f, 2**31 + 7),
                       ops.bulk_hash_seeded(f, full))


def test_murmur_grid_equals_numpy_engine_grid():
    """Device seeds above 2**32 (and 2**63) and fields above 2**32
    exercise the truncation to 32 bits."""
    rng = np.random.default_rng(5)
    fields = rng.integers(0, 2**40, (200, 5), dtype=np.uint64)
    dev_seed = rng.integers(0, 2**64 - 1, (200, 64), dtype=np.uint64)
    dev_seed[0, :3] = [2**40 + 17, 2**63, 2**64 - 1]
    want = _murmur_hash_grid(fields, dev_seed)
    got = ops.murmur_hash_grid(torch.from_numpy(fields.view(np.int64)),
                               torch.from_numpy(dev_seed.view(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_pinned_paper_testbed_values():
    """tests/test_kernels.py's pinned values for the Pallas kernel hold
    for the port's simulate_paper_paths and bulk_hash."""
    rng = np.random.default_rng(42)
    fields = torch.from_numpy(rng.integers(0, 2**31, (4096, 5)))
    ch = ops.simulate_paper_paths(fields)
    want = {
        "src_port": ([1, 1, 0, 1, 1, 0, 1, 0], 1958, [2138, 1958]),
        "uplink": ([14, 12, 13, 9, 2, 8, 1, 8], 30992,
                   [245, 268, 264, 235, 244, 247, 276, 258]),
        "spine_link": ([0, 1, 0, 3, 1, 0, 1, 1], 6196,
                       [1028, 992, 1024, 1052]),
        "dst_port": ([1, 1, 1, 1, 0, 1, 0, 1], 2086, [2010, 2086]),
    }
    for stage, (first8, total, counts) in want.items():
        got = ch[stage].numpy()
        assert got[:8].tolist() == first8, stage
        assert int(got.sum()) == total, stage
        assert np.bincount(got)[: len(counts)].tolist() == counts, stage
    h = ops.bulk_hash(fields, 12345).numpy()
    assert h[:4].tolist() == [1282828036, 453300701, 462728589, 1920719609]
    assert int(h.sum()) == 8712584361707


def test_link_loads_fim_matches_reference():
    rng = np.random.default_rng(8)
    choices = rng.integers(0, 16, 1000).astype(np.int32)
    want_counts, want_fim = jops.link_loads_fim(jnp.asarray(choices), 16)
    counts, fim = ops.link_loads_fim(torch.from_numpy(choices), 16)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert fim == pytest.approx(want_fim, rel=1e-12)


def test_cpu_calls_leave_launch_counts_unchanged():
    ops.reset_launches()
    f = torch.zeros((10, 5), dtype=torch.int64)
    ops.bulk_hash(f, 1)
    ops.bulk_hash_seeded(f, torch.arange(10))
    ops.murmur_hash_grid(f, torch.zeros((10, 4), dtype=torch.int64))
    ops.simulate_paper_paths(f)
    assert ops.LAUNCHES == {"murmur_hash_grid": 0, "bulk_hash": 0}


@pytest.mark.parametrize("fields, seeds, exc", [
    (torch.zeros((4, 5), dtype=torch.int32),
     torch.zeros((4, 2), dtype=torch.int64), TypeError),
    (torch.zeros((4, 5), dtype=torch.int64),
     torch.zeros((3, 2), dtype=torch.int64), TypeError),
    (torch.zeros((5, 4), dtype=torch.int64).T,
     torch.zeros((4, 2), dtype=torch.int64), ValueError),
])
def test_grid_wrapper_rejects_what_the_kernel_does_not_take(fields, seeds,
                                                           exc):
    with pytest.raises(exc):
        ops.murmur_hash_grid(fields, seeds)

