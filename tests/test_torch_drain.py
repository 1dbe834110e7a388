"""The departure drain (``kernels/drain``) against the JAX package's
``departure_fill``, on the CPU.

``departure_fill`` hands the drain its live (column, seed) cells in the
fill's seed-major order; the wrapper's plain version must give every
cell the reference's completion time bit for bit, and the reference's
drain rounds, for any weights, efficiency and round-1 rates.  The card's
kernel (a block per seed) is held against the plain version in
``test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core.vector_throughput import dedup_link_ids  # noqa: E402
from repro_torch.kernels.drain import build, ops  # noqa: E402


def _cells(ids, L):
    """The drain's inputs from an (H, N, S) link tensor with every
    column live: seed-major cell ids, seeds, columns."""
    H, N, S = ids.shape
    t = torch.from_numpy(ids).transpose(1, 2).reshape(H, S * N)
    seed = torch.arange(S).repeat_interleave(N)
    col = torch.arange(N).repeat(S)
    return torch.where(t >= 0, t + seed * L, S * L), seed, col


@pytest.mark.parametrize("trial", range(6))
def test_plain_version_is_the_reference_drain(trial):
    rng = np.random.default_rng(3000 + trial)
    H, N, S, L = 3, int(rng.integers(2, 40)), int(rng.integers(1, 6)), 9
    ids = dedup_link_ids(rng.integers(-1, L, size=(H, N, S)))
    gb = rng.uniform(0.5, 20.0, size=N)
    cap = rng.uniform(50.0, 200.0, size=L)
    eff = rng.uniform(0.3, 1.0, size=(N, S))
    w = rng.uniform(0.2, 3.0, size=N) if trial % 2 else None
    init = R.batched_max_min(ids, cap, weights=w) if trial % 3 == 0 else None
    want = R.departure_fill(ids, cap, gb, weights=w, efficiency=eff,
                            assume_unique=True, initial_rates=init)
    cells, seed, col = _cells(ids, L)
    got = ops.departure_drain(
        cells, seed, S, torch.from_numpy(cap), torch.from_numpy(gb)[col],
        torch.from_numpy(eff)[col, seed],
        None if w is None else torch.from_numpy(w)[col],
        None if init is None else torch.from_numpy(init)[col, seed], N + 1)
    assert got.flops is None               # only the kernel counts them
    np.testing.assert_array_equal(got.done.numpy(),
                                  want.completion[col.numpy(), seed.numpy()])
    assert got.rounds == want.rounds


def test_round_guard_and_zero_goodput_raise():
    cells, seed, col = _cells(np.zeros((1, 2, 1), np.int64), 1)
    args = (cells, seed, 1, torch.tensor([100.0]),
            torch.tensor([8.0, 24.0]), torch.ones(2), None, None)
    assert ops.departure_drain(*args, 2).rounds == 2
    with pytest.raises(RuntimeError, match="converge"):
        ops.departure_drain(*args, 1)
    dead = (cells, seed, 1, torch.tensor([0.0]), torch.tensor([1.0, 1.0]),
            torch.ones(2), None, None, 3)
    with pytest.raises(RuntimeError, match="zero goodput"):
        ops.departure_drain(*dead)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    cells, seed, _ = _cells(np.zeros((1, 2, 1), np.int64), 1)
    meta = [t.to("meta") for t in (cells, seed)]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.departure_drain(meta[0], meta[1], 1, torch.ones(1),
                            torch.ones(2), torch.ones(2), None, None, 3)


def test_shared_memory_fits_the_default_fabrics():
    # a CTA keeps three float64 rows and an int32 row per link beside
    # lists for one cell a thread
    assert ops.max_links() >= 1_024 * 6
    assert (ops.smem_bytes(ops.max_links(), ops.THREADS) <= ops.SMEM_BUDGET
            < ops.smem_bytes(ops.max_links() + 1, ops.THREADS))
    assert build.SOURCE.name == "drain.cu" and build.SOURCE.is_file()
    ops.reset_launches()
    assert ops.LAUNCHES == {"departure_drain": 0}


# (seeds, cells a seed, links, hops) -> (cluster, chunks, cells a CTA):
# ECMP's and prime-spray's widest full-width steps (the MoE all-to-all,
# 4,096 and 32,768 columns x 64 seeds over the default multipod
# fabric's 1,024 links), the card check's 2 seeds, more seeds than the
# card has SMs, one seed, six hops, and a fabric at max_links()
PLANS = [
    ((64, 4_096, 1_024, 4), (2, 1, 2_048)),
    ((64, 32_768, 1_024, 4), (2, 1, 16_384)),
    ((2, 32_768, 1_024, 4), (4, 1, 8_192)),
    ((200, 5_000, 48, 4), (1, 1, 5_000)),
    ((1, 5_000, 48, 4), (2, 1, 2_500)),
    ((4, 700, 30, 6), (1, 2, 700)),
    ((2, 900, ops.max_links(), 4), (2, 1, 450)),
]


@pytest.mark.parametrize("shape, want", PLANS)
def test_plan_picks_the_launch_shape(shape, want):
    pl = ops.plan(*shape)
    assert (pl.cluster, pl.chunks, pl.cells_per_block) == want
    assert pl.cluster * pl.cells_per_block >= shape[1]
    assert pl.smem_bytes == ops.smem_bytes(shape[2], pl.cells_per_block)
    assert pl.smem_bytes <= ops.SMEM_BUDGET


def test_plan_keeps_every_seed_resident():
    # prime-spray's step on a card that keeps 30 clusters of 4 resident:
    # 64 seeds stay at 2 and 30 seeds spread to 4; a card that keeps
    # no cluster of 2 leaves ECMP's seeds at 1
    def resident(c, _):
        return {2: 66, 4: 30, 8: 14}[c]
    assert ops.plan(64, 32_768, 1_024, 4, resident=resident).cluster == 2
    assert ops.plan(30, 32_768, 1_024, 4, resident=resident).cluster == 4
    assert ops.plan(64, 4_096, 1_024, 4, resident=lambda c, _: 0).cluster == 1


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_plan_takes_a_forced_cluster(cluster):
    pl = ops.plan(3, 5_000, 48, 4, cluster=cluster)
    assert pl.cluster == cluster
    assert pl.cells_per_block == -(-5_000 // cluster)


# shapes the kernel cannot take, and the limit each error names
REFUSED = [
    ((64, 4_096, 1_024, 9), "at most 8"),
    ((64, 4_096, ops.max_links() + 1, 4), f"at most {ops.max_links()}"),
    ((64, 8 * 65_536 + 1, 1_024, 4), "cells a seed do not fit"),
    ((1, 200_000, 14_000, 4), "at most 8512 a seed"),
    ((64, 40_000, 1_024, 4, ops.SMS, 1), "do not fit 1 CTAs"),
    ((64, 4_096, 1_024, 4, ops.SMS, 3), "takes 1, 2, 4 or 8"),
]


@pytest.mark.parametrize("shape, msg", REFUSED)
def test_plan_refuses_what_does_not_fit(shape, msg):
    with pytest.raises(ValueError, match=msg):
        ops.plan(*shape)
