"""Opt-in runtime contract checks for the simulation seams.

``FLOWTRACER_CONTRACTS=1`` arms cheap shape/dtype/finiteness assertions
at the three places every simulation flows through — ``resolve_spec``
(the front-end glue), ``simulate_paths`` (the routed tensor), and
``throughput_from_result`` (the rate aggregation) — so the tensors that
actually crossed a seam are held to what the docstrings say.

Off by default and read from the environment on every call, so a test
can flip it with ``monkeypatch.setenv``.  The checks are reductions of
already-materialized tensors on whatever device holds them (each read
of a result to the host is one synchronisation, paid only when the
checks are on).

Violations raise ``ContractViolation`` (an ``AssertionError`` subclass,
so ``pytest.raises(AssertionError)`` also matches) naming the seam and
the invariant.
"""

from __future__ import annotations

import os

import torch

CONTRACTS_ENV = "FLOWTRACER_CONTRACTS"

_OFF = ("", "0", "false", "off", "no")


class ContractViolation(AssertionError):
    """A runtime contract at a simulation seam did not hold."""


def contracts_enabled() -> bool:
    """True when ``FLOWTRACER_CONTRACTS`` is set to anything truthy."""
    return os.environ.get(CONTRACTS_ENV, "").strip().lower() not in _OFF


def _fail(seam: str, invariant: str) -> None:
    raise ContractViolation(f"[{CONTRACTS_ENV}] {seam}: {invariant}")


def _is_integer(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


def check_spec(s) -> None:
    """Post-conditions of ``resolve_spec``: the spec is *resolved* —
    every device-coupled default concretized, scalars validated."""
    seam = "resolve_spec"
    if not (isinstance(s.max_hops, int) and s.max_hops >= 1):
        _fail(seam, f"resolved max_hops must be an int >= 1, "
                    f"got {s.max_hops!r}")
    if not isinstance(s.device, torch.device):
        _fail(seam, f"resolved spec left device as {s.device!r} "
                    f"(resolve() must make it a torch.device)")
    if s.hash_backend is None:
        _fail(seam, "resolved spec left hash_backend unset (resolve() "
                    "must concretize the device-coupled default)")
    if s.fields is None:
        _fail(seam, "resolved spec left fields unset")
    if isinstance(s.strategy, str):
        _fail(seam, f"resolved spec left strategy as the name string "
                    f"{s.strategy!r} (resolve() must look it up)")
    if isinstance(s.transport, str) and s.transport != "ideal":
        _fail(seam, f"resolved spec left transport as the name string "
                    f"{s.transport!r}")


def check_trace_result(res) -> None:
    """Post-conditions of ``simulate_paths``: the routed tensor is a
    well-formed ``VectorTraceResult`` (shapes agree, link ids in range,
    flowlet demands positive and summing to 1 per parent flow)."""
    seam = "simulate_paths"
    ids = res.link_ids
    if ids.dim() != 3:
        _fail(seam, f"link_ids must be (H, Nf, S), got shape "
                    f"{tuple(ids.shape)}")
    if not _is_integer(ids):
        _fail(seam, f"link_ids must be an integer tensor, got {ids.dtype}")
    num_links = res.compiled.num_links
    if ids.numel():
        lo, hi = torch.stack([ids.min(), ids.max()]).tolist()
        if lo < -1 or hi >= num_links:
            _fail(seam, f"link ids must lie in [-1, {num_links}), "
                        f"got range [{lo}, {hi}]")
    _h, nf, s_dim = ids.shape
    if res.seeds.shape != (s_dim,):
        _fail(seam, f"seeds shape {res.seeds.shape} does not match the "
                    f"link_ids seed axis ({s_dim})")
    n = res.num_flows
    fi = res.flow_index
    if tuple(fi.shape) != (nf,):
        _fail(seam, f"flow_index shape {tuple(fi.shape)} does not match "
                    f"the flowlet axis ({nf})")
    if nf:
        lo, hi = torch.stack([fi.min(), fi.max()]).tolist()
        if lo < 0 or hi >= n:
            _fail(seam, f"flow_index must name parent rows in [0, {n}), "
                        f"got range [{lo}, {hi}]")
    dem = res.demand
    if tuple(dem.shape) != (nf,):
        _fail(seam, f"demand shape {tuple(dem.shape)} does not match the "
                    f"flowlet axis ({nf})")
    if not bool((torch.isfinite(dem) & (dem > 0)).all()):
        _fail(seam, "flowlet demand fractions must be finite and > 0")
    per_flow = torch.zeros(n, dtype=torch.float64, device=dem.device)
    per_flow.index_add_(0, fi, dem.to(torch.float64))
    if not torch.allclose(per_flow, torch.ones_like(per_flow)):
        worst = float((per_flow - 1).abs().max())
        _fail(seam, "flowlet demand fractions must sum to 1 per parent "
                    f"flow (worst deviation {worst:.3g})")
    fd = res.flow_demand
    if tuple(fd.shape) != (n,):
        _fail(seam, f"flow_demand shape {tuple(fd.shape)} must be ({n},)")
    if not bool((torch.isfinite(fd) & (fd >= 0)).all()):
        _fail(seam, "flow_demand weights must be finite and >= 0")
    if res.extra_exposure is not None:
        ex = res.extra_exposure
        if tuple(ex.shape) != (n, s_dim):
            _fail(seam, f"extra_exposure shape {tuple(ex.shape)} must be "
                        f"({n}, {s_dim})")
        if not bool((torch.isfinite(ex) & (ex >= 0)).all()):
            _fail(seam, "extra_exposure must be finite and >= 0")


def check_throughput(tp) -> None:
    """Post-conditions of ``throughput_from_result``: finite non-negative
    rates, efficiency in (0, 1], and goodput = rates x efficiency."""
    seam = "throughput_from_result"
    n, s_dim = len(tp.flows), len(tp.seeds)
    if tuple(tp.rates.shape) != (n, s_dim):
        _fail(seam, f"rates shape {tuple(tp.rates.shape)} must be "
                    f"({n}, {s_dim})")
    if not bool((torch.isfinite(tp.rates) & (tp.rates >= 0)).all()):
        _fail(seam, "rates must be finite and >= 0")
    if len(tp.pairs) != tp.per_pair.shape[0] \
            or tp.per_pair.shape[1] != s_dim:
        _fail(seam, f"per_pair shape {tuple(tp.per_pair.shape)} must be "
                    f"({len(tp.pairs)}, {s_dim})")
    if not bool(torch.isfinite(tp.per_pair).all()):
        _fail(seam, "per-pair rates must be finite")
    eff = tp.efficiency
    if not bool(((eff > 0) & (eff <= 1.0)).all()):
        _fail(seam, "efficiency must lie in (0, 1]")
    if not bool((torch.isfinite(tp.exposure) & (tp.exposure >= 0)).all()):
        _fail(seam, "exposure must be finite and >= 0")
    if not torch.allclose(tp.goodput, tp.rates * eff):
        _fail(seam, "goodput must equal rates x efficiency")
