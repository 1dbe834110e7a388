"""Transport reordering profiles: exposure -> goodput efficiency.

The port's own copy of the profile half of ``repro.core.reordering``:
``TransportProfile``, ``calibrate_transport``, the published anchor
points and the three shipped profiles (``ideal``, ``roce-nack``,
``strack``).  A profile maps a flow's out-of-order exposure to a goodput
multiplier::

    efficiency = 1 + (1 - floor) * expm1(-alpha * exposure)

Single-path ECMP — the only routing this slice of the port runs — has
zero exposure, so every profile leaves its goodput equal to its rates;
the exposure pass itself (``flowlet_exposure``) comes with the spraying
strategies.  The profiles live in a plain port-local dict: the port
registers nothing in the JAX package's registries.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

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
