"""Plain version of the departure drain (the kernel's oracle and the CPU
path): the JAX package's ``departure_fill`` loop on PyTorch tensors,
every seed's live cells in one whole-tensor round, each round a fresh
max-min fill (``core.vector_throughput._fill_block``) of the survivors."""

from __future__ import annotations

import torch


def departure_drain_ref(cells: torch.Tensor, seed: torch.Tensor,
                        n_seeds: int, cap: torch.Tensor, gbits: torch.Tensor,
                        eff: torch.Tensor, w: torch.Tensor | None,
                        init: torch.Tensor | None,
                        max_rounds: int) -> tuple[torch.Tensor, int, int]:
    """The arguments of ``ops.departure_drain``; returns the (A,)
    completion seconds of every cell, the drain rounds and the freeze
    rounds of every fill, summed.  Each round reads the host once beside
    its fill (the survivors' count and the zero-goodput flag)."""
    from ...core.vector_throughput import _fill_block, _split

    dev = cells.device
    f64 = torch.float64
    inf = float("inf")
    S = n_seeds
    L = cap.numel()
    SL = S * L
    cap_rep = cap.repeat(S)
    A = seed.numel()
    done = torch.zeros(A, dtype=f64, device=dev)
    pos = torch.arange(A, device=dev)      # each live cell's place in done
    rem = gbits
    t = torch.zeros(S, dtype=f64, device=dev)
    rounds = fill_rounds = 0
    while pos.numel():
        rounds += 1
        if rounds > max_rounds:            # >= 1 cell departs per round per
            raise RuntimeError(            # active seed, so this is unreachable
                "departure_fill failed to converge (rate degeneracy?)")
        if init is not None:
            rates, init = init, None
        else:
            rates, r = _fill_block(cells, SL, cap_rep, w)
            fill_rounds += r
        good = rates * eff
        fin = rem / good
        fin = torch.where(torch.isnan(fin), inf, fin)
        # (S,) next departure horizon: cells are seed-sorted, so a
        # segmented minimum (no atomics; a seed with no cell reads inf)
        dt = torch.segment_reduce(
            fin, "min", lengths=torch.bincount(seed, minlength=S))
        dt_c = dt[seed]
        zero_goodput = (~torch.isfinite(dt_c)).any()
        dt0 = torch.where(torch.isfinite(dt), dt, 0.0)
        # everything within float tolerance of the horizon departs
        # together; a survivor's time is rewritten when it departs
        depart = fin <= dt_c * (1.0 + 1e-12)
        done[pos] = t[seed] + fin
        rem = torch.clamp(
            rem - torch.where(torch.isfinite(good), good, 0.0) * dt0[seed],
            min=0.0)
        t = t + dt0
        keep, _, stuck = _split(~depart, zero_goodput)
        if stuck:
            raise RuntimeError(
                "departure_fill: active flow with zero goodput can never "
                "finish (zero-capacity bottleneck link?)")
        cells, seed, pos = cells[:, keep], seed[keep], pos[keep]
        rem, eff = rem[keep], eff[keep]
        if w is not None:
            w = w[keep]
    return done, rounds, fill_rounds
