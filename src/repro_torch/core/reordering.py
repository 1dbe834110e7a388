"""Flowlet reordering cost: exposure -> goodput efficiency.

The port's own copy of ``repro.core.reordering``: ``TransportProfile``,
``calibrate_transport``, the published anchor points, the three shipped
profiles (``ideal``, ``roce-nack``, ``strack``), and the exposure model.
A multi-path result's flows see out-of-order delivery in proportion to
their flowlets' path-length skew and rate dispersion
(``flowlet_exposure``, on the result's device); a profile maps it to a
goodput multiplier::

    efficiency = 1 + (1 - floor) * expm1(-alpha * exposure)

Single-path flows have zero exposure, so every profile leaves their
goodput equal to their rates.  The profiles live in a plain port-local
dict: the port registers nothing in the JAX package's registries.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

#: one fabric round-trip at datacenter scale (tens of microseconds) —
#: the unit the event-timed timeline prices adaptation in
DEFAULT_RTT_SECONDS = 25e-6


@dataclasses.dataclass(frozen=True)
class TransportProfile:
    """Reordering tolerance of a transport: exposure -> efficiency.

    ``alpha`` is the decay rate (how fast goodput erodes per unit
    exposure) and ``floor`` the asymptotic efficiency under unbounded
    reordering (the transport's worst case).  ``alpha=0`` or ``floor=1``
    makes reordering free.  ``rtt_seconds`` is the transport's feedback
    loop length, read by event-timed adaptive re-spray.
    """

    name: str
    alpha: float
    floor: float
    rtt_seconds: float = DEFAULT_RTT_SECONDS

    def __post_init__(self):
        if self.alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        if not 0.0 < self.floor <= 1.0:
            raise ValueError(f"floor must be in (0, 1], got {self.floor}")
        if not self.rtt_seconds > 0:
            raise ValueError(
                f"rtt_seconds must be > 0, got {self.rtt_seconds}")


def calibrate_transport(
    name: str,
    anchors: Sequence[tuple[float, float]],
    *,
    grid: int = 4000,
) -> TransportProfile:
    """Fit a ``TransportProfile`` through published (exposure,
    efficiency) anchor points.

    The model is linear in ``(1 - floor)`` once alpha is fixed, so the
    fit is a 1-D deterministic grid search over alpha (log-spaced) with
    the closed-form least-squares ``floor`` at each candidate.  Anchors
    at exposure 0 are rejected (the model passes through (0, 1) exactly).
    """
    pts = [(float(x), float(y)) for x, y in anchors]
    if len(pts) < 2:
        raise ValueError(f"need >= 2 anchor points, got {len(pts)}")
    for x, y in pts:
        if x <= 0:
            raise ValueError(
                f"anchor exposure must be > 0 (the model is exact at 0), "
                f"got {x}")
        if not 0.0 < y < 1.0:
            raise ValueError(f"anchor efficiency must be in (0, 1), got {y}")
    x = np.array([p[0] for p in pts], dtype=np.float64)
    y = np.array([p[1] for p in pts], dtype=np.float64)
    alphas = np.exp(np.linspace(np.log(1e-3), np.log(50.0), grid))
    g = np.expm1(-alphas[:, None] * x[None, :])        # (grid, P)
    # least squares for u = 1 - floor in  (y - 1) = u * g,  clipped to
    # the valid floor range (0, 1]
    u = np.clip((g * (y - 1.0)[None, :]).sum(1) / (g * g).sum(1),
                0.0, 1.0 - 1e-9)
    sse = (((1.0 + u[:, None] * g) - y[None, :]) ** 2).sum(1)
    best = int(np.argmin(sse))
    return TransportProfile(name, alpha=float(alphas[best]),
                            floor=float(1.0 - u[best]))


#: reordering is free — the default everywhere
IDEAL = TransportProfile("ideal", alpha=0.0, floor=1.0)

#: anchor points (exposure, goodput efficiency) read off the published
#: goodput-vs-reordering behaviour in STrack (arXiv 2407.15266): RoCE
#: with go-back-N loss recovery collapses to about a quarter of line rate
#: under heavy reordering ...
ROCE_NACK_ANCHORS = ((0.25, 0.78), (0.5, 0.60), (1.0, 0.38), (4.0, 0.26))
#: ... while STrack's out-of-order range tracking keeps near line rate.
STRACK_ANCHORS = ((0.25, 0.985), (0.5, 0.97), (1.0, 0.945), (4.0, 0.88))

#: go-back-N RoCE NACK semantics, calibrated through ROCE_NACK_ANCHORS
ROCE_NACK = calibrate_transport("roce-nack", ROCE_NACK_ANCHORS)
#: STrack-like out-of-order tracking, calibrated through STRACK_ANCHORS
STRACK = calibrate_transport("strack", STRACK_ANCHORS)

#: name -> profile, for ``transport="name"``
TRANSPORTS: dict[str, TransportProfile] = {
    p.name: p for p in (IDEAL, ROCE_NACK, STRACK)}


def register_transport(profile: TransportProfile, *,
                       replace: bool = False) -> TransportProfile:
    """Register ``profile`` so ``transport="name"`` resolves to it.

    A duplicate name raises unless ``replace=True``: every benchmark and
    test resolves transports by name, so silently overwriting e.g.
    ``"roce-nack"`` would re-anchor all their goodput numbers without a
    trace."""
    if not replace and profile.name in TRANSPORTS:
        raise ValueError(
            f"transport profile {profile.name!r} is already registered "
            f"(registered: {available_transports()}); pass replace=True "
            f"to overwrite it")
    TRANSPORTS[profile.name] = profile
    return profile


def available_transports() -> list[str]:
    return sorted(TRANSPORTS)


def resolve_transport(
    transport: TransportProfile | str | None,
) -> TransportProfile:
    """A profile instance passes through; a name looks up ``TRANSPORTS``;
    ``None`` means ``ideal`` (reordering-free)."""
    if transport is None:
        return IDEAL
    if isinstance(transport, TransportProfile):
        return transport
    if isinstance(transport, str):
        try:
            return TRANSPORTS[transport]
        except KeyError:
            raise ValueError(
                f"unknown transport profile {transport!r}; "
                f"registered: {available_transports()}") from None
    raise TypeError(
        f"transport must be a TransportProfile, registered name, or None, "
        f"got {type(transport).__name__}")


def flowlet_exposure(result, flowlet_rates: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """(N, S) out-of-order exposure per flow per seed, on the result's
    device: the skew of the flowlets' hop counts ``(hmax - hmin) /
    max(hmin, 1)`` plus the dispersion of their per-unit-demand max-min
    rates ``(rmax - rmin) / rmax``.

    ``flowlet_rates`` is the ``(Nf, S)`` per-column rate tensor
    (``max_min_rates(result)``); passing it saves a second fill.
    Zero-link flowlets carry infinite rates and traverse no shared
    queue, so they are left out of the dispersion (a flow whose
    flowlets are all link-free disperses nothing).
    ``result.extra_exposure`` is added on top.
    """
    from .vector_sim import segment_reduce

    n, s = result.num_flows, result.num_seeds
    extra = result.extra_exposure
    fi = result.flow_index
    dev = result.link_ids.device
    if not result.is_multipath and bool(
            (fi == torch.arange(n, device=dev)).all()):
        base = torch.zeros((n, s), dtype=torch.float64, device=dev)
        return base if extra is None else base + extra
    inf = float("inf")
    hops = result.hop_counts().to(torch.float64)                   # (Nf, S)
    hmin = segment_reduce(hops, fi, n, "amin", inf)
    hmax = segment_reduce(hops, fi, n, "amax", -inf)
    skew = (hmax - hmin) / hmin.clamp(min=1.0)
    if flowlet_rates is None:
        from .vector_throughput import max_min_rates
        flowlet_rates = max_min_rates(result)
    unit = flowlet_rates / result.column_weights()[:, None]
    finite = torch.isfinite(unit)
    rmin = segment_reduce(torch.where(finite, unit, inf), fi, n, "amin", inf)
    rmax = segment_reduce(torch.where(finite, unit, -inf), fi, n, "amax",
                          -inf)
    live = torch.isfinite(rmax) & (rmax > 0)
    dispersion = torch.where(live, (rmax - torch.where(live, rmin, 0.0))
                             / torch.where(live, rmax, 1.0), 0.0)
    exposure = skew + dispersion
    # parents with no columns (only in hand-built results) reorder
    # nothing; scrub the fallback's inf/nan seeds
    exposure = torch.where(torch.isfinite(exposure), exposure, 0.0)
    return exposure if extra is None else exposure + extra


def rtt_round_budget(duration_s: float, rtt_s: float, cap: int) -> int:
    """Adaptation rounds a transfer of ``duration_s`` seconds affords:
    ``ceil(duration / rtt)``, floored at 1 (the initial pick always
    happens) and capped at ``cap`` (the strategy's configured rounds)."""
    if not rtt_s > 0:
        raise ValueError(f"rtt_s must be > 0, got {rtt_s}")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if not duration_s >= 0:                # also rejects nan
        raise ValueError(f"duration_s must be >= 0, got {duration_s}")
    return int(np.clip(np.ceil(duration_s / rtt_s), 1, cap))


def reordering_efficiency(
    exposure: torch.Tensor,
    transport: TransportProfile | str | None = None,
) -> torch.Tensor:
    """Goodput multiplier in ``(0, 1]`` for an exposure tensor:
    ``1 + (1 - floor) * expm1(-alpha * exposure)``, exactly 1.0 at zero
    exposure (``expm1(-0) == -0``), decaying monotonically toward
    ``floor``."""
    p = resolve_transport(transport)
    e = torch.as_tensor(exposure, dtype=torch.float64)
    if bool((e < 0).any()):
        raise ValueError("exposure must be non-negative")
    return 1.0 + (1.0 - p.floor) * torch.expm1(-p.alpha * e)
