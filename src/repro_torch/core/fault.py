"""Fabric fault model: topology churn events consumed by ``fabric.FabricState``.

The port's copy of ``repro.core.fault``: the same events, records and
injector, plain Python values (times, cores, ports), no tensors.

The paper's not-all-stop model assumes every OCS core stays up for the whole
horizon. Production fabrics do not: cores fail (a switch loses power, a
controller wedges), ports flap (a transceiver bounces for seconds), and the
reconfiguration delay drifts as optics age. This module is the *event
vocabulary* for that churn; the semantics — what happens to committed
circuits, in-flight transmissions and the tentative schedule — live in
``fabric.FabricState.apply_fault`` and are summarized here:

``CoreDown(t, core)``
    From time ``t`` the core schedules nothing: its horizon resources are
    pushed to ``+inf`` and the assignment state masks it. Committed circuits
    on the core are *classified*: those completing at or before ``t`` were
    delivered and are kept; those still in flight (``t_complete > t``) are
    aborted — their full demand is re-queued as residual flows with release
    ``max(release, t)`` and reassigned greedily over the surviving cores
    (an interrupted optical transfer delivers nothing; bytes are re-served
    exactly once, never lost, never double-counted). Tentative (uncommitted)
    flows stranded on the core are likewise reassigned; commitments on
    surviving cores are never rewritten.

``CoreUp(t, core)``
    The core rejoins at ``t``: horizons are rebuilt from the surviving
    committed circuits and new assignments may choose it again. The greedy
    assignment state RESETS the recovered core's accumulated load
    (``FlatAssignState.reset_core``): a core that went down delivered
    nothing while dark and its interrupted circuits were re-queued onto the
    survivors, so its true outstanding load is zero — keeping the stale
    pre-failure history would under-use the recovered core indefinitely.
    The recovered core is the cheapest candidate until its fresh load
    catches up, converging the fabric back toward the healthy mix.

``PortFlap(t, t_end, core, port)``
    The port's transceiver is unusable on ``[t, t_end)`` in both directions.
    Committed circuits touching ``(core, port)`` that overlap the window are
    aborted and re-queued like a core failure; the port's availability
    horizon is floored at ``t_end`` so nothing new is matched through it
    before the flap clears. (The control plane reacts at its tick cadence,
    so a tentative circuit that could still have squeezed in before ``t``
    is conservatively pushed past ``t_end``.)

``DeltaDrift(t, core, delta)``
    The core's reconfiguration delay is re-measured as ``delta`` from ``t``
    on. Every circuit *not yet committed* when the drift is processed uses
    the new per-core delay (committed establishments are already programmed
    and keep their timing); the tau-aware assignment state prices the core
    with its drifted delay from then on. Priority scores keep the nominal
    fabric delta — priorities are assigned at admission and never re-read
    the fabric.

Faults are applied at service-tick boundaries: ``FabricState.step`` pops
every injector event due at or before the tick time *before* admitting the
tick's arrivals (the control plane learns of a fault when it wakes).
``service.FabricManager.report_fault`` applies a single event immediately
between ticks — including events timestamped in the past (late discovery:
circuits the manager believed delivered are retro-aborted and re-queued).

Late discovery is bounded by ``FabricState``'s ``fault_lookback`` window:
commits completing at or before ``t_now - fault_lookback`` can never be
aborted by an admissible event (classification only aborts circuits with
``t_comp > t_fault``), so the watermark GC drops them (exact count in
``FabricState.commits_gced``) and a ``CoreDown``/``PortFlap`` timestamped
before the watermark is rejected with ``ValueError``. The default
``fault_lookback=inf`` retains every commit forever (the pre-GC behavior).

A ``FaultInjector`` with zero events is bit-identical to no injector at
all, tick by tick.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

__all__ = [
    "CoreDown",
    "CoreUp",
    "PortFlap",
    "DeltaDrift",
    "AbortedCircuit",
    "FaultApplication",
    "FaultInjector",
    "FaultEvent",
    "FAULT_EVENTS",
]


@dataclasses.dataclass(frozen=True)
class CoreDown:
    """Core ``core`` fails at time ``t`` (wall time of the fabric stream)."""

    t: float
    core: int


@dataclasses.dataclass(frozen=True)
class CoreUp:
    """Core ``core`` rejoins the fabric at time ``t``."""

    t: float
    core: int


@dataclasses.dataclass(frozen=True)
class PortFlap:
    """Port ``port`` on core ``core`` is unusable on ``[t, t_end)``, both
    directions (a bouncing transceiver takes ingress and egress with it)."""

    t: float
    t_end: float
    core: int
    port: int

    def __post_init__(self) -> None:
        if not self.t_end > self.t:
            raise ValueError(
                f"flap window must be non-empty: [{self.t}, {self.t_end})")


@dataclasses.dataclass(frozen=True)
class DeltaDrift:
    """Core ``core``'s reconfiguration delay is ``delta`` from time ``t``."""

    t: float
    core: int
    delta: float

    def __post_init__(self) -> None:
        if self.delta < 0:
            raise ValueError("drifted delta must be >= 0")


#: Event classes understood by ``FabricState.apply_fault``.
FAULT_EVENTS = (CoreDown, CoreUp, PortFlap, DeltaDrift)
FaultEvent = Union[CoreDown, CoreUp, PortFlap, DeltaDrift]


@dataclasses.dataclass(frozen=True)
class AbortedCircuit:
    """One committed circuit torn down by a fault (telemetry + corrective
    program emission). ``t_abort`` is the fault time that killed it."""

    gid: int
    cid: int
    i: int
    j: int
    core: int
    size: float
    t_establish: float
    t_abort: float

    @property
    def key(self) -> tuple:
        """Identity of the circuit segment inside the stream-wide program
        (gid + ports + core + establishment time is unique: a re-committed
        flow gets a new establishment time)."""
        return (self.gid, self.i, self.j, self.core, self.t_establish)


@dataclasses.dataclass(frozen=True)
class FaultApplication:
    """What applying one fault event to a ``FabricState`` actually did."""

    event: object
    aborted: tuple  # (AbortedCircuit, ...) — committed circuits torn down
    requeued: int   # aborted flows re-queued as residual demand
    reassigned_pending: int  # tentative flows moved off the affected core
    unfinalized: tuple       # gids whose final CCT was retracted

    @property
    def n_aborted(self) -> int:
        return len(self.aborted)


class FaultInjector:
    """Time-ordered fault schedule consumed by ``FabricState.step``.

    Events are applied when the first tick at or after their timestamp is
    processed (strictly in event-time order, ties in construction order).
    The injector is a one-pass cursor: each event fires exactly once.
    """

    def __init__(self, events: Sequence["FaultEvent"] = ()) -> None:
        events = tuple(events)
        for ev in events:
            if not isinstance(ev, FAULT_EVENTS):
                raise TypeError(
                    f"unknown fault event {ev!r}; one of "
                    f"{[c.__name__ for c in FAULT_EVENTS]}")
            if ev.t < 0:
                raise ValueError(f"fault times must be >= 0, got {ev.t}")
        self._events = sorted(events, key=lambda ev: ev.t)
        self._next = 0

    def __len__(self) -> int:
        return len(self._events)

    @property
    def pending(self) -> tuple:
        """Events not yet consumed, in firing order."""
        return tuple(self._events[self._next:])

    def pop_due(self, t_now: float) -> tuple:
        """Consume and return every pending event with ``t <= t_now``."""
        lo = self._next
        hi = lo
        while hi < len(self._events) and self._events[hi].t <= t_now:
            hi += 1
        self._next = hi
        return tuple(self._events[lo:hi])
