"""The ordered per-bin load sum (``kernels/loads``) against the JAX
package's load sums, on the CPU.

The routing strategies sum demand-weighted link loads into (seed, link)
bins in C order over the ``(H, N, S)`` cells, the reference's
``np.bincount`` order (``_weighted_link_loads``).  The ordered sum's
wrapper must give those sums bit for bit for any weights; its plain
version is ``torch.bincount`` on the CPU, and on the card a stable sort
of the keys and a left fold of each bin's run, modelled here in numpy.
``_cell_loads`` keeps the atomic bincount only where every weight sum is
exact in any order.  The card's kernel is held against the plain
version in ``test_torch_gpu.py``.
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


def random_cells(rng, H, N, S, L):
    ids = rng.integers(0, L, (H, N, S)).astype(np.int32)
    ids[rng.random((H, N, S)) < 0.2] = -1
    return ids


def cell_keys(ids, L):
    """The int32 (seed, link) keys of ``_cell_loads``: -1 cells take the
    skip key S * L."""
    H, N, S = ids.shape
    keys = np.where(ids >= 0, ids + np.arange(S, dtype=np.int32) * L, S * L)
    return torch.from_numpy(keys.astype(np.int32).reshape(-1))


WEIGHTS = {
    "unit": (lambda n: np.ones(n), True),
    "flowlets 1/8": (lambda n: np.full(n, 1 / 8), True),
    "wave": (lambda n: np.ones(n) * 1.0, True),
    "dyadic bytes": (lambda n: np.where(np.arange(n) % 2, 0.5, 1.5), True),
    "bytes 2^20/2^30": (byte_weights, False),
    "flowlets 1/3": (lambda n: np.full(n, 1 / 3), False),
    "bytes over 8 flowlets": (lambda n: byte_weights(n) / 8, False),
}


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_exact_in_any_order(name):
    make, exact = WEIGHTS[name]
    w = torch.from_numpy(make(64))
    assert ops.exact_in_any_order(w, 10**9) == exact


def test_exactness_bounds_the_partial_sums():
    """2**q-multiples stay exact until the largest partial sum reaches
    2**53 * 2**q; non-finite weights never pass."""
    w = torch.tensor([3.0, 0.75], dtype=torch.float64)   # q = -2, max 12 q
    assert ops.exact_in_any_order(w, 2**53 // 12)
    assert not ops.exact_in_any_order(w, 2**53 // 12 + 1)
    assert ops.exact_in_any_order(torch.zeros(4, dtype=torch.float64), 9)
    assert not ops.exact_in_any_order(
        torch.tensor([1.0, float("inf")], dtype=torch.float64), 2)
    assert not ops.exact_in_any_order(
        torch.tensor([1.0, float("nan")], dtype=torch.float64), 2)


@pytest.mark.parametrize("shape", [(4, 300, 9, 40), (6, 2000, 3, 17),
                                   (1, 1, 1, 1)])
@pytest.mark.parametrize("name", ["bytes 2^20/2^30", "flowlets 1/3", "unit"])
def test_ordered_sum_is_the_reference_load_sum(shape, name):
    H, N, S, L = shape
    rng = np.random.default_rng(N)
    ids = random_cells(rng, H, N, S, L)
    w = WEIGHTS[name][0](N) * rng.choice([1.0, 3.7, 1e-3], N)
    want = RS._weighted_link_loads(ids, w, L)
    w_cells = torch.from_numpy(np.broadcast_to(
        w[None, :, None], ids.shape).reshape(-1).copy())
    got = ops.ordered_bin_sum(cell_keys(ids, L), w_cells, S * L)
    assert np.array_equal(got.numpy(), want.reshape(-1))        # bit for bit
    got = TS._cell_loads(torch.from_numpy(ids), torch.from_numpy(w), L)
    assert np.array_equal(got.numpy(), want)


def test_stable_sort_and_left_fold_is_bincount():
    """The kernel's algorithm, in numpy: a stable sort of the keys puts
    each bin's positions in one ascending run, integer counts and their
    cumulative sum bound the runs, and a left fold of each run from 0.0
    gives ``np.bincount``'s sums bit for bit.  Summing the same weights
    in another order does not."""
    rng = np.random.default_rng(17)
    n_bins, m = 50, 20_000
    keys = rng.integers(0, n_bins + 1, m)                 # n_bins: skipped
    w = np.exp(rng.normal(0, 12, m))
    perm = np.argsort(keys, kind="stable")
    start = np.concatenate([[0], np.cumsum(
        np.bincount(keys, minlength=n_bins + 1)[:n_bins])])
    got = np.zeros(n_bins)
    for b in range(n_bins):
        acc = 0.0
        for i in perm[start[b]:start[b + 1]]:
            acc += w[i]
        got[b] = acc
    want = np.bincount(keys, weights=w, minlength=n_bins + 1)[:n_bins]
    assert np.array_equal(got, want)
    shuffled = rng.permutation(m)
    other = np.bincount(keys[shuffled], weights=w[shuffled],
                        minlength=n_bins + 1)[:n_bins]
    assert not np.array_equal(other, want)


def test_sort_runs_bounds_each_bins_positions():
    """The wrapper's runs (torch ops, the same on either device): bin b's
    positions, ascending, are ``perm[start[b]:start[b + 1]]``; keys at
    or above ``n_bins`` fall after every run."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, 5_000).astype(np.int32)
    perm, start = ops.sort_runs(torch.from_numpy(keys), 33)
    perm, start = perm.numpy(), start.numpy()
    assert start.shape == (34,) and start[0] == 0
    for b in range(33):
        np.testing.assert_array_equal(perm[start[b]:start[b + 1]],
                                      np.flatnonzero(keys == b))
    assert sorted(perm[start[-1]:]) == list(np.flatnonzero(keys >= 33))


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_cell_loads_orders_only_sums_that_need_it(monkeypatch, name):
    """``_cell_loads`` takes the ordered sum exactly where the
    exactness test fails, and its loads are the reference's either way."""
    calls = []
    real = ops.ordered_bin_sum

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(TS.loads, "ordered_bin_sum", spy)
    rng = np.random.default_rng(9)
    ids = random_cells(rng, 3, 200, 5, 24)
    make, exact = WEIGHTS[name]
    w = make(200)
    got = TS._cell_loads(torch.from_numpy(ids), torch.from_numpy(w), 24)
    assert calls == ([] if exact else [1])
    assert np.array_equal(got.numpy(), RS._weighted_link_loads(ids, w, 24))


def test_ordered_sum_checks_its_inputs():
    k = torch.zeros(4, dtype=torch.int32)
    w = torch.ones(4, dtype=torch.float64)
    with pytest.raises(TypeError):
        ops.ordered_bin_sum(k.long(), w, 3)
    with pytest.raises(TypeError):
        ops.ordered_bin_sum(k, w.float(), 3)
    with pytest.raises(ValueError):
        ops.ordered_bin_sum(k[:3], w, 3)
    with pytest.raises(ValueError):
        ops.ordered_bin_sum(k, w, 2**31 - 1)
    assert ops.LAUNCHES == {"ordered_bin_sum": 0}
