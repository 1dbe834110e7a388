"""The ordered (seed, link) load sum (``kernels/loads``) against the JAX
package's load sums, on the CPU.

The routing strategies sum demand-weighted link loads into (seed, link)
bins in C order over the ``(H, N, S)`` cells, the reference's
``np.bincount`` order (``_weighted_link_loads``).  The ordered sum's
wrapper must give those sums bit for bit for any weights; its plain
version is ``torch.bincount`` on the CPU.  On the card each CTA owns
one seed's bins (or a run of its links), streams the seed's cells in
tiles, ranks each tile stably in shared memory and adds each bin's slots
in order: that algorithm is modelled here in numpy and held against
``np.bincount``.  ``_cell_loads`` takes the ordered sum for every
weight.  The card's kernel is held against the plain version in
``test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import strategies as RS  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.kernels.loads import ops  # noqa: E402


def byte_weights(n):
    """Per-flow byte demand of alternating 2**20 and 2**30-byte flows,
    normalised to mean 1 as ``flow_demand_weights`` does."""
    b = np.where(np.arange(n) % 2 == 0, 2.0**20, 2.0**30)
    return b / b.mean()


def random_cells(rng, H, N, S, L, skip=0.2):
    ids = rng.integers(0, L, (H, N, S)).astype(np.int32)
    ids[rng.random((H, N, S)) < skip] = -1
    return ids


WEIGHTS = {
    "unit": lambda n: np.ones(n),
    "flowlets 1/8": lambda n: np.full(n, 1 / 8),
    "wave": lambda n: np.ones(n) * 1.0,
    "dyadic bytes": lambda n: np.where(np.arange(n) % 2, 0.5, 1.5),
    "bytes 2^20/2^30": byte_weights,
    "flowlets 1/3": lambda n: np.full(n, 1 / 3),
    "bytes over 8 flowlets": lambda n: byte_weights(n) / 8,
}


def kernel_model(ids, w, L, links_per_block, rows_per_tile, warps=2,
                 lanes=8):
    """``csrc/loads.cu``'s algorithm in numpy, step for step.

    Each CTA owns the bins of one seed and ``links_per_block`` links (key
    l - l0) and walks the seed's cells, rows (h, n), a tile at a time
    (how a cluster brings the rows in does not touch the sums).  Warp w
    ranks its segment of the tile in chunks of ``lanes`` cells: the lanes
    that hold one key (the chunk's mask of that key) take the warp's
    count of that key plus their place among those lanes, and the count
    grows by their number.  The CTA scans the keys' totals in key order
    and each (warp, key) its counts over the warps: a key's slots then
    name its rows in cell order, and the key's owner adds their weights
    left to right into a sum it keeps over the tiles."""
    H, N, S = ids.shape
    rows = ids.reshape(H * N, S)
    row_w = np.tile(w, H)
    out = np.full((S, L), np.nan)
    lp = links_per_block
    for s in range(S):
        for l0 in range(0, L, lp):
            owned = min(lp, L - l0)
            sums = [0.0] * lp
            for r0 in range(0, H * N, rows_per_tile):
                cells = np.full(rows_per_tile, -1, np.int64)
                part = rows[r0:r0 + rows_per_tile, s]
                cells[:part.size] = part
                key = cells - l0
                keep = (key >= 0) & (key < owned)
                key = np.where(keep, key, -1)
                seg = -(-cells.size // warps)
                count = np.zeros((warps, lp), np.int64)
                rank = np.zeros(cells.size, np.int64)
                for wi in range(warps):
                    for c0 in range(wi * seg, min((wi + 1) * seg, cells.size),
                                    lanes):
                        chunk = key[c0:min(c0 + lanes, (wi + 1) * seg)]
                        for i, k in enumerate(chunk):
                            if k >= 0:
                                grp = np.flatnonzero(chunk == k)
                                rank[c0 + i] = count[wi, k] + np.sum(grp < i)
                        for k in set(chunk[chunk >= 0].tolist()):
                            count[wi, k] += np.sum(chunk == k)
                total = count.sum(0)
                start = np.concatenate([[0], np.cumsum(total)[:-1]])
                offset = start[None, :] + np.cumsum(count, 0) - count
                slots = np.full(total.sum(), -1)
                for c in np.flatnonzero(keep):
                    slots[offset[c // seg, key[c]] + rank[c]] = c
                for k in range(lp):
                    for j in range(start[k], start[k] + total[k]):
                        sums[k] = sums[k] + row_w[r0 + slots[j]]
            out[s, l0:l0 + owned] = sums[:owned]
    return out


#: the model's edge cases: (H, N, S, L, share of -1 cells); links_per_block
#: 4 with 40 links splits each seed's links over blocks
MODEL_CASES = {
    "bin split across tiles": (2, 60, 3, 4, 0.1),
    "every cell in one link": (2, 40, 5, 7, "one link"),
    "-1 cells": (3, 30, 4, 6, 0.6),
    "one seed": (2, 50, 1, 9, 0.2),
    "seeds not a multiple of 8": (2, 20, 11, 5, 0.2),
    "links over several blocks": (1, 40, 9, 40, 0.2),
}


@pytest.mark.parametrize("rows_per_tile", [7, 64])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_owned_bins_tiles_stable_ranks_and_left_folds_are_bincount(
        case, rows_per_tile):
    """The kernel's algorithm gives ``np.bincount``'s sums bit for bit
    under log-normal weights, with a seed's links whole or split over
    CTAs."""
    H, N, S, L, skip = MODEL_CASES[case]
    rng = np.random.default_rng(len(case) + rows_per_tile)
    if skip == "one link":
        ids = np.full((H, N, S), 3, np.int32)
    else:
        ids = random_cells(rng, H, N, S, L, skip)
    w = np.exp(rng.normal(0, 12, N))
    want = RS._weighted_link_loads(ids, w, L)
    for lp in (L, 4, max(1, L // 3)):
        got = kernel_model(ids, w, L, lp, rows_per_tile)
        assert np.array_equal(got, want), lp
    got = ops.ordered_cell_sum(torch.from_numpy(ids), torch.from_numpy(w), L)
    assert np.array_equal(got.numpy(), want)


def test_another_order_gives_other_sums():
    """Summing the same cells' log-normal weights in another order than
    C order moves sums: the order is part of the result."""
    rng = np.random.default_rng(17)
    H, N, S, L = 4, 600, 5, 8
    ids = random_cells(rng, H, N, S, L)
    w = np.exp(rng.normal(0, 12, N))
    want = RS._weighted_link_loads(ids, w, L)
    keys = np.where(ids >= 0, ids + np.arange(S) * L, S * L).reshape(-1)
    wc = np.broadcast_to(w[None, :, None], ids.shape).reshape(-1)
    p = rng.permutation(keys.size)
    other = np.bincount(keys[p], weights=wc[p],
                        minlength=S * L + 1)[:S * L].reshape(S, L)
    assert not np.array_equal(other, want)
    assert np.allclose(other, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("shape", [(4, 300, 9, 40), (6, 2000, 3, 17),
                                   (1, 1, 1, 1)])
@pytest.mark.parametrize("name", ["bytes 2^20/2^30", "flowlets 1/3", "unit"])
def test_ordered_sum_is_the_reference_load_sum(shape, name):
    H, N, S, L = shape
    rng = np.random.default_rng(N)
    ids = random_cells(rng, H, N, S, L)
    w = WEIGHTS[name](N) * rng.choice([1.0, 3.7, 1e-3], N)
    want = RS._weighted_link_loads(ids, w, L)
    got = ops.ordered_cell_sum(torch.from_numpy(ids), torch.from_numpy(w), L)
    assert got.dtype == torch.float64 and got.shape == (S, L)
    assert np.array_equal(got.numpy(), want)                    # bit for bit
    got = TS._cell_loads(torch.from_numpy(ids), torch.from_numpy(w), L)
    assert np.array_equal(got.numpy(), want)


#: weights whose float64 sums are exact in any order (the old atomic
#: branch's), each on two shapes: the ordered sum gives them too
EXACT = ["unit", "dyadic bytes", "flowlets 1/8", "wave"]


@pytest.mark.parametrize("shape", [(3, 500, 7, 24), (5, 64, 16, 3)])
@pytest.mark.parametrize("name", EXACT)
def test_exact_weights_sum_as_in_any_order(name, shape):
    H, N, S, L = shape
    rng = np.random.default_rng(H * N)
    ids = random_cells(rng, H, N, S, L)
    w = WEIGHTS[name](N)
    got = ops.ordered_cell_sum(torch.from_numpy(ids), torch.from_numpy(w), L)
    assert np.array_equal(got.numpy(), RS._weighted_link_loads(ids, w, L))
    keys = np.where(ids >= 0, ids + np.arange(S) * L, S * L).reshape(-1)
    wc = np.broadcast_to(w[None, :, None], ids.shape).reshape(-1)
    p = rng.permutation(keys.size)
    shuffled = np.bincount(keys[p], weights=wc[p], minlength=S * L + 1)
    assert np.array_equal(got.numpy().reshape(-1), shuffled[:S * L])


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_cell_loads_takes_the_ordered_sum_for_every_weight(monkeypatch,
                                                           name):
    """``_cell_loads`` sends every weight to the ordered sum (on the CPU
    its plain version), and its loads are the reference's."""
    calls = []
    real = ops.ordered_cell_sum

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(TS.loads, "ordered_cell_sum", spy)
    rng = np.random.default_rng(9)
    ids = random_cells(rng, 3, 200, 5, 24)
    w = WEIGHTS[name](200)
    got = TS._cell_loads(torch.from_numpy(ids), torch.from_numpy(w), 24)
    assert calls == [1]
    assert np.array_equal(got.numpy(), RS._weighted_link_loads(ids, w, 24))


def test_plan_fits_the_keys_a_cta_owns():
    assert ops.plan(1024) == 1024
    assert ops.plan(1025) == 513 and ops.plan(3000) == 1000
    assert ops.plan(5) == 5 and ops.plan(0) == 1
    for links in (1, 7, 1023, 1025, 2048, 2049, 40_000):
        lp = ops.plan(links)
        parts = -(-links // lp)
        assert 1 <= lp <= ops.MAX_KEYS and parts * lp >= links
        # the fewest CTAs that fit, each owning at least one link
        assert parts == -(-links // ops.MAX_KEYS)
        assert (parts - 1) * lp < links


def test_ordered_sum_checks_its_inputs():
    ids = torch.zeros((2, 4, 3), dtype=torch.int32)
    w = torch.ones(4, dtype=torch.float64)
    with pytest.raises(TypeError):
        ops.ordered_cell_sum(ids.long(), w, 3)
    with pytest.raises(TypeError):
        ops.ordered_cell_sum(ids, w.float(), 3)
    with pytest.raises(ValueError):
        ops.ordered_cell_sum(ids, w[:3], 3)
    with pytest.raises(ValueError):
        ops.ordered_cell_sum(ids.reshape(8, 3), w, 3)
    with pytest.raises(ValueError):
        ops.ordered_cell_sum(
            torch.zeros((2, 3, 4), dtype=torch.int32).transpose(1, 2), w, 3)
    with pytest.raises(ValueError):
        ops.ordered_cell_sum(ids, w, 2**31 - 1)
    assert ops.ordered_cell_sum(ids, w, 3).tolist() == [[8.0, 0, 0]] * 3
    assert ops.LAUNCHES == {"ordered_cell_sum": 0}


@pytest.mark.parametrize("table", ["compare_variants", "profile_laps"])
def test_source_anchors_stand_once(table):
    """Each line that ``compare.py``'s variants and probes replace, and
    each phase mark (``LAP(k);``) that a ``-DLOADS_PROFILE`` build counts
    into ``compare.RANKING`` and ``compare.ADDING``, stands in the
    kernel's source exactly once, so each build measures what it names."""
    from repro_torch.kernels.loads import build, compare
    text = build.SOURCE.read_text()
    if table == "compare_variants":
        for name, (old, new) in {**compare.VARIANTS,
                                 **compare.PROBES}.items():
            assert text.count(old) == 1, name
            assert old != new, name
    else:
        phases = len(compare.RANKING) + len(compare.ADDING)
        assert f"constexpr int PHASES = {phases};" in text
        for k in range(phases):
            assert text.count(f"LAP({k});") == 1, k
        assert f"LAP({phases});" not in text
