"""Plain version of the sequential congestion-aware placement (the
kernel's oracle and the CPU path): the JAX package's host loop
(``_sequential_congestion_place``), one flow at a time over every seed
at once, in numpy on the CPU tensors' memory.

Per hop it reads the candidate loads of all seeds, takes the least
loaded candidate, and where candidates tie hashes the flow (murmur3 or
the exact splitmix fold) and takes the tie of rank ``hash % n_tie``;
after the walk it adds the flow's weight to every link it took, in one
fancy-index add, so each link's load sums in flow order as the
reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..flowhash.ref import murmur_hash_grid_ref

_HASH_INIT = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    return x ^ (x >> np.uint64(31))


def flow_hash(fields: np.ndarray, dev_seed: np.ndarray,
              murmur: bool) -> np.ndarray:
    """The hash grid of uint64 host arrays, (N, F) fields and (N, S)
    device seeds -> (N, S) uint64: murmur3 (``murmur_hash_grid_ref`` on
    int64 views) or the exact fold ``mix64(... mix64(seed ^ INIT) ^ f
    ...)``, the same integer operations as the port's tensor hashes."""
    if murmur:
        return murmur_hash_grid_ref(fields.view(np.int64),
                                    dev_seed.view(np.int64)).view(np.uint64)
    h = _mix64(dev_seed ^ _HASH_INIT)
    for f in range(fields.shape[1]):
        h = _mix64(h ^ fields[:, f:f + 1])
    return h


def congestion_place_ref(
    cand: torch.Tensor, cand_n: torch.Tensor, dev_crc: torch.Tensor,
    is_server: torch.Tensor, link_dst: torch.Tensor, fields: torch.Tensor,
    seeds: torch.Tensor, src_dev: torch.Tensor, dst_dev: torch.Tensor,
    src_key: torch.Tensor, dst_key: torch.Tensor, weight: torch.Tensor,
    order: torch.Tensor, load: torch.Tensor, link_ids: torch.Tensor,
    mask: torch.Tensor | None = None, *, num_keys: int, c_max: int,
    max_hops: int, murmur: bool,
) -> tuple[int, tuple | None]:
    """The arguments and result of ``ops.congestion_place``, on CPU
    tensors (``load`` and ``link_ids`` are written in place)."""
    cand = cand.numpy().reshape(-1, c_max)
    cand_n, link_dst = cand_n.numpy(), link_dst.numpy()
    dev_crc = dev_crc.numpy().view(np.uint64)
    is_server = is_server.numpy()
    fields = fields.numpy().view(np.uint64)
    seeds_u64 = seeds.numpy().view(np.uint64)
    src_dev, dst_dev = src_dev.numpy(), dst_dev.numpy()
    src_key, dst_key = src_key.numpy(), dst_key.numpy()
    weight = weight.numpy()
    masks = None if mask is None else mask.numpy()
    ids = link_ids.numpy()
    s, n_links = load.shape
    load_flat = load.numpy().reshape(-1)    # writable view for scatters
    rows = np.arange(s, dtype=np.int64)
    row_off = rows * n_links
    col_idx = np.arange(c_max, dtype=np.int64)[None, :]
    hops = 0
    for pos, j in enumerate(order.numpy()):
        m = None if masks is None else masks[j]
        if m is not None and not m.any():
            continue
        state = np.full(s, int(src_dev[j]), np.int64)
        done = np.zeros(s, bool)
        t_end = 0
        for t in range(max_hops):
            if done.all():
                break
            t_end = t + 1
            key = np.where(is_server[state], src_key[j], dst_key[j])
            vk = state * num_keys + key
            nc = cand_n[vk]                                # (S,)
            cw = min(int(nc.max()), c_max) or 1            # live table width
            cands = cand[vk, :cw]                          # (S, cw)
            valid = (col_idx[:, :cw] < nc[:, None]) & (cands >= 0)
            cl = np.where(valid,
                          load_flat[row_off[:, None] + np.maximum(cands, 0)],
                          np.inf)
            tie = valid & (cl == cl.min(axis=1)[:, None])
            n_tie = tie.sum(axis=1)
            multi = n_tie > 1
            if multi.any():                # hash only when a tie exists
                h = flow_hash(fields[j:j + 1],
                              (dev_crc[state] ^ seeds_u64)[None, :],
                              murmur)[0]
                rank = np.where(
                    multi,
                    (h % np.maximum(n_tie, 1).astype(np.uint64)).astype(
                        np.int64),
                    0)
                col = (tie.cumsum(axis=1) <= rank[:, None]).sum(axis=1)
            else:
                col = tie.argmax(axis=1)   # unique minimum (or 0)
            link = cands[rows, np.minimum(col, cw - 1)]
            link = np.where(done | (nc == 0), -1, link)
            if m is None:
                ids[t, j] = link
            else:
                ids[t, j, m] = link[m]
            active = link >= 0
            nxt = np.where(active, link_dst[np.maximum(link, 0)], state)
            done |= ~active | is_server[nxt]
            state = nxt
        hops = max(hops, t_end)
        settled = done if m is None else (done | ~m)
        if not settled.all():
            bad = int(np.flatnonzero(~settled)[0])
            return hops, (pos, bad, 1, int(state[bad]))
        arrived = done & (state == dst_dev[j])
        if m is not None:
            arrived |= ~m
        if not arrived.all():
            bad = int(np.flatnonzero(~arrived)[0])
            return hops, (pos, bad, 2, int(state[bad]))
        # fused load tally over all hops at once: (seed, link) cells of
        # one flow are unique (loop-free path), so a direct fancy-index
        # add is exact
        taken = ids[:t_end, j]                         # (h, S)
        keep = taken >= 0
        if m is not None:
            keep = keep & m[None, :]
        cells = (taken.astype(np.int64) + row_off[None, :])[keep]
        load_flat[cells] += weight[j]
    return hops, None
