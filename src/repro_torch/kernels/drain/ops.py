"""The departure-ordered max-min drain of event timing on the card.

``departure_drain`` drains every live (column, seed) cell's gigabits:
each round a max-min fill of the live cells, each cell's finish time
``rem / (rate x efficiency)``, the seed's earliest finish its horizon,
the cells within 1e-12 of it departing at ``t + finish`` and the others
draining for it — ``core.vector_throughput.departure_fill``'s loop.
Seeds never interact, so the kernel in ``csrc/drain.cu`` runs each
seed's whole drain in one block: one launch and one read of its
statistics, where the plain version launches dozens of ops and reads the
host once per freeze round.  A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version in ``ref.py``.
``LAUNCHES`` counts kernel launches (CPU calls never count).
"""

from __future__ import annotations

import dataclasses

import torch

from . import build
from .ref import departure_drain_ref

#: kernel launches, counted only where the kernel launches
LAUNCHES = {"departure_drain": 0}
#: dynamic shared memory one block may use on sm_90 (227 KB): four
#: float64 link rows and a byte row, beside 32 float64 of reduction space
SMEM_BUDGET = 232_448
_THREADS = 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def max_links() -> int:
    """The most links a fabric may have for one block's shared memory."""
    return (SMEM_BUDGET - (_THREADS // 32) * 8) // 33


@dataclasses.dataclass
class Drain:
    """What a drain returns: ``done`` (A,) completion seconds per cell,
    the drain rounds (the most any seed ran), the freeze rounds of the
    fills (the plain version: summed over its rounds; the kernel: the
    most any seed ran) and, from the kernel only, the float64 operations
    it did (``flops``)."""

    done: torch.Tensor
    rounds: int
    fill_rounds: int
    flops: int | None = None


def departure_drain(cells: torch.Tensor, seed: torch.Tensor, n_seeds: int,
                    cap: torch.Tensor, gbits: torch.Tensor,
                    eff: torch.Tensor, w: torch.Tensor | None,
                    init: torch.Tensor | None, max_rounds: int) -> Drain:
    """Drain ``A`` live cells of ``n_seeds`` seeds over ``L`` links.

    ``cells`` (H, A) int64 holds ``seed * L + link`` per hop (``S * L``
    for no link), ``seed`` (A,) int64 each cell's seed, non-decreasing;
    ``cap`` (L,), ``gbits`` (A,) > 0, ``eff`` (A,) and the optional
    weights ``w`` (A,) and round-1 rates ``init`` (A,) are float64.
    ``max_rounds`` guards the loop (a fault past it raises)."""
    H, A = cells.shape
    if cells.dtype != torch.int64 or seed.dtype != torch.int64:
        raise TypeError(f"cells and seed must be int64, got {cells.dtype} "
                        f"and {seed.dtype}")
    for name, t in (("seed", seed), ("gbits", gbits), ("eff", eff),
                    ("w", w), ("init", init)):
        if t is not None and tuple(t.shape) != (A,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                             f"cells need ({A},)")
    dev = cells.device
    if dev.type == "cpu":
        return Drain(*departure_drain_ref(cells, seed, n_seeds, cap, gbits,
                                          eff, w, init, max_rounds))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S, L = int(n_seeds), cap.numel()
    if L > max_links():
        raise ValueError(f"{L} links do not fit one block's shared memory "
                         f"(at most {max_links()})")
    f64 = torch.float64
    if A == 0:
        return Drain(torch.zeros(0, dtype=f64, device=dev), 0, 0, 0)
    links = torch.where(cells < S * L, cells - seed * L, -1).to(
        torch.int32).contiguous()
    seg = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(seed, minlength=S), 0, out=seg[1:])
    args = [t.to(dtype=f64).contiguous() for t in (cap, gbits, eff)]
    opt = [None if t is None else t.to(dtype=f64).contiguous()
           for t in (w, init)]
    rem, rate, fm, done = (torch.empty(A, dtype=f64, device=dev)
                           for _ in range(4))
    st = torch.empty(A, dtype=torch.uint8, device=dev)
    stats = torch.zeros((S, 4), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().departure_drain(
            links.data_ptr(), seg.data_ptr(), *(t.data_ptr() for t in args),
            *(0 if t is None else t.data_ptr() for t in opt),
            rem.data_ptr(), rate.data_ptr(), fm.data_ptr(), st.data_ptr(),
            done.data_ptr(), stats.data_ptr(), A, int(max_rounds), H, L, S,
            stream)
    if rc != 0:
        raise RuntimeError(f"departure_drain launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["departure_drain"] += 1
    stats = stats.cpu()                    # the launch's one host read
    fault = int(stats[:, 3].max())
    if fault == 1:
        raise RuntimeError(
            "departure_fill: active flow with zero goodput can never "
            "finish (zero-capacity bottleneck link?)")
    if fault:
        raise RuntimeError(
            "departure_fill failed to converge (rate degeneracy?)")
    return Drain(done, int(stats[:, 0].max()), int(stats[:, 1].max()),
                 int(stats[:, 2].sum()))
