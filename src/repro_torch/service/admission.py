"""Admission control: the request queue in front of the incremental engine.

The port's copy of ``repro.service.admission``: the same queue, policy and
exact counters over the port's :class:`~repro_torch.core.coflow.Coflow`.

Arrival requests (one coflow + its release time) are enqueued as they reach
the fabric manager and drained in micro-batches at each service tick: a
tick at time T admits every queued request released at or before T, in
submission order (the engine re-sorts a batch into arrival order
internally). Requests released in the future stay queued.

Backpressure is a hard bound on queue depth: beyond ``max_depth`` pending
requests, :meth:`AdmissionQueue.push` raises :class:`BackpressureError` and
counts the rejection — the caller (load balancer, client library) must slow
down or retry; silently unbounded queues are how control planes melt.

Overload survival is :class:`AdmissionPolicy` (Varys-style order ->
allocate -> reject, with work-conserving backfilling):

  - **flow budget** — the tentative backlog is capped in FLOWS, not queue
    entries (one coflow can carry thousands of circuits, and the per-tick
    event-loop cost scales with pending flows). A released request whose
    flow count exceeds the remaining budget is DEFERRED to the next tick —
    but later, smaller requests are still admitted past it
    (work-conserving backfilling, the WSS allocate loop of SNIPPETS §2).
  - **shedding** — when the released backlog still exceeds ``shed_depth``
    after a drain, the lowest-priority-score requests (the ones the WSPT
    order would serve last anyway) are moved to a standby buffer instead of
    churning the scheduler every tick.
  - **backfill** — once the released backlog drains to ``resume_depth``,
    standby requests re-enter the queue in their shed order: shed work is
    deferred, not lost (and ``FabricManager.flush`` recalls all of it).
  - **hard drop** — the standby buffer is itself bounded
    (``max_standby``); overflow permanently rejects the oldest standby
    requests, counted in :attr:`AdmissionQueue.dropped`.

Every transition is counted exactly (``rejected``, ``late``, ``deferred``
plus its flow-weighted twin ``deferred_flows``, ``shed``, ``backfilled``,
``dropped``), so telemetry can account for every
submitted coflow: admitted + queued + standby + rejected + dropped ==
submitted, at all times.

Late arrivals — a release at or before the fabric's last committed tick,
for which bit-exact scheduling is no longer possible because those circuits
are already programmed — are clamped to just after the last tick (the
coflow is treated as arriving now) and counted, mirroring what a real
fabric manager does with a request that raced its own admission window.
A request that is late only because the policy deferred or shed it is NOT
counted late again — the clamp is the policy's doing, not the caller's.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.coflow import Coflow
from repro_torch.core.effects import effects
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["ArrivalRequest", "AdmissionPolicy", "BackpressureError",
           "AdmissionQueue"]


class BackpressureError(RuntimeError):
    """The admission queue is full; the caller must slow down."""


@dataclasses.dataclass(frozen=True)
class ArrivalRequest:
    """One coflow arrival: the demand plus its release (arrival) time.

    ``score`` is the coflow's WSPT priority score at submission (used to
    pick shedding victims — lowest score sheds first); ``n_flows`` its flow
    count (what the flow budget charges); ``deferred`` marks a request the
    policy already held back at least once (its late-clamp is then
    accounted to the policy, not the caller).
    """

    coflow: Coflow
    release: float
    submitted_s: float  # telemetry clock (obs.clock.now) at submission
    score: float = 0.0
    n_flows: int = 0
    deferred: bool = False


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Overload-survival knobs for :class:`AdmissionQueue` (all optional;
    the default policy enforces nothing and reproduces plain FIFO drains).

    ``max_pending_flows`` caps the engine's tentative backlog in flows: a
    drain admits released requests in order but never pushes the pending
    flow count past the cap, deferring over-budget requests while
    backfilling later smaller ones. ``shed_depth``/``resume_depth`` are the
    shed/backfill watermarks over the *released* queue backlog, and
    ``max_standby`` bounds the standby buffer (``None`` = unbounded).
    """

    max_pending_flows: int | None = None
    shed_depth: int | None = None
    resume_depth: int | None = None
    max_standby: int | None = None

    def __post_init__(self) -> None:
        for name in ("max_pending_flows", "shed_depth", "resume_depth",
                     "max_standby"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        if self.resume_depth is not None:
            if self.shed_depth is None:
                raise ValueError("resume_depth without shed_depth is "
                                 "meaningless: nothing is ever shed")
            if self.resume_depth > self.shed_depth:
                raise ValueError(
                    f"resume_depth ({self.resume_depth}) must be <= "
                    f"shed_depth ({self.shed_depth}) or shed/backfill "
                    f"would oscillate within one drain")
        if self.max_standby is not None and self.shed_depth is None:
            raise ValueError("max_standby without shed_depth is "
                             "meaningless: nothing is ever shed")

    @property
    def effective_resume_depth(self) -> int:
        """Backfill watermark (defaults to half the shed watermark)."""
        if self.resume_depth is not None:
            return self.resume_depth
        return 0 if self.shed_depth is None else self.shed_depth // 2

    @property
    def enforces_anything(self) -> bool:
        return (self.max_pending_flows is not None
                or self.shed_depth is not None)


class AdmissionQueue:
    """Bounded FIFO of arrival requests with micro-batch draining."""

    def __init__(self, max_depth: int = 1024,
                 policy: AdmissionPolicy | None = None,
                 metrics: MetricsRegistry | None = None) -> None:
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = int(max_depth)
        self.policy = policy if policy is not None else AdmissionPolicy()
        self.metrics = MetricsRegistry() if metrics is None else metrics
        # registry-backed transition counters (read via the properties
        # below, which keep the pre-registry attribute names)
        self._rejected = self.metrics.counter("admission.rejected")
        self._late = self.metrics.counter("admission.late")
        self._deferred = self.metrics.counter("admission.deferred")
        self._deferred_flows = self.metrics.counter(
            "admission.deferred_flows")
        self._shed_c = self.metrics.counter("admission.shed")
        self._backfilled = self.metrics.counter("admission.backfilled")
        self._dropped = self.metrics.counter("admission.dropped")
        self._q: deque[ArrivalRequest] = deque()
        self._standby: deque[ArrivalRequest] = deque()

    @property
    def rejected(self) -> int:
        """Push backpressure (queue full)."""
        return self._rejected.value

    @property
    def late(self) -> int:
        """Caller-raced releases clamped at admission."""
        return self._late.value

    @property
    def deferred(self) -> int:
        """Flow-budget deferrals (events, not requests)."""
        return self._deferred.value

    @property
    def deferred_flows(self) -> int:
        """Flows held back by those deferral events (flow-weighted: one
        big coflow deferred for 10 ticks adds ``10 * n_flows`` here but
        only 10 to :attr:`deferred` — the gap is how much *work* the
        budget is pushing into the future, which the event count hides)."""
        return self._deferred_flows.value

    @property
    def shed(self) -> int:
        """Requests moved to standby."""
        return self._shed_c.value

    @property
    def backfilled(self) -> int:
        """Standby requests re-entering the queue."""
        return self._backfilled.value

    @property
    def dropped(self) -> int:
        """Standby overflow: permanently rejected."""
        return self._dropped.value

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        """Active queue depth (standby not included; see standby_depth)."""
        return len(self._q)

    @property
    def standby_depth(self) -> int:
        return len(self._standby)

    @property
    def total_depth(self) -> int:
        """Every request the queue still owes the fabric."""
        return len(self._q) + len(self._standby)

    @property
    def max_release(self) -> float:
        """Latest release among queued + standby requests (-inf if none)."""
        return max(
            max((r.release for r in self._q), default=-np.inf),
            max((r.release for r in self._standby), default=-np.inf))

    def push(self, req: ArrivalRequest) -> None:
        """Enqueue, or raise :class:`BackpressureError` when full."""
        if len(self._q) >= self.max_depth:
            self._rejected.inc()
            raise BackpressureError(
                f"admission queue full ({self.max_depth} pending requests); "
                f"retry after the next service tick")
        self._q.append(req)

    def requeue_front(self, reqs: list[ArrivalRequest]) -> None:
        """Put already-admitted requests back at the head of the queue (in
        their original order) after a failed tick; exempt from the depth
        bound — they were admitted once and must not be dropped."""
        self._q.extendleft(reversed(reqs))

    def recall_standby(self) -> int:
        """Move every standby request back into the active queue (end of
        stream: the flush must not leave shed work behind). Exempt from the
        depth bound, like requeue_front. Returns the count recalled."""
        n = len(self._standby)
        if n:
            self._backfilled.inc(n)
            self._q.extend(self._standby)
            self._standby.clear()
        return n

    def _backfill(self, t_now: float) -> None:
        """Standby re-enters when the released backlog has drained below the
        resume watermark (work-conserving: shed work is deferred, not lost)."""
        pol = self.policy
        if not self._standby or pol.shed_depth is None:
            return
        released = sum(1 for r in self._q if r.release <= t_now)
        if released > pol.effective_resume_depth:
            return
        room = pol.shed_depth - released
        while self._standby and room > 0:
            self._q.append(self._standby.popleft())
            self._backfilled.inc()
            room -= 1

    def _shed(self, keep: deque, t_now: float) -> deque:
        """Move the lowest-score released leftovers above ``shed_depth``
        into standby; overflow beyond ``max_standby`` is dropped for good."""
        pol = self.policy
        if pol.shed_depth is None:
            return keep
        kept = list(keep)
        released = [x for x, r in enumerate(kept) if r.release <= t_now]
        excess = len(released) - pol.shed_depth
        if excess <= 0:
            return keep
        # victims: lowest WSPT score first; newest first among ties (the
        # oldest equal-priority work has waited longest and stays)
        victims = set(sorted(
            released, key=lambda x: (kept[x].score, -x))[:excess])
        self._shed_c.inc(excess)
        for x in sorted(victims):
            self._standby.append(
                dataclasses.replace(kept[x], deferred=True))
        kept = [r for x, r in enumerate(kept) if x not in victims]
        if pol.max_standby is not None:
            while len(self._standby) > pol.max_standby:
                self._standby.popleft()
                self._dropped.inc()
        return deque(kept)

    @effects()
    def drain(self, t_now: float, t_floor: float,
              flow_budget: int | None = None) -> list[ArrivalRequest]:
        """Dequeue every request released at or before ``t_now`` that fits
        the flow budget.

        Requests released at or before ``t_floor`` (the fabric's last
        committed tick) are LATE: their release is clamped to just after
        ``t_floor`` so the incremental engine can still admit them, and the
        clamp is counted in :attr:`late` — unless the request was deferred
        or shed by the policy, in which case the clamp is the policy's own
        doing and is not the caller's lateness. Submission order is
        preserved; future releases stay queued.

        ``flow_budget`` (None = unbounded) is the number of tentative flows
        the engine can still take: an over-budget released request is
        deferred (counted in :attr:`deferred`) while later smaller requests
        keep being admitted — work-conserving backfilling. After the walk,
        shedding/backfill run against the leftover released backlog.
        """
        self._backfill(t_now)
        admitted, keep = [], deque()
        floor = float(np.nextafter(t_floor, np.inf))
        budget = flow_budget
        while self._q:
            req = self._q.popleft()
            if req.release > t_now:
                keep.append(req)
                continue
            is_late = req.release <= t_floor
            if is_late and floor > t_now:
                # the admissible window (t_floor, t_now] is empty (tick
                # repeated the committed time); hold until it reopens
                keep.append(req)
                continue
            if budget is not None and req.n_flows > budget:
                self._deferred.inc()
                self._deferred_flows.inc(req.n_flows)
                if not req.deferred:
                    req = dataclasses.replace(req, deferred=True)
                keep.append(req)
                continue
            if budget is not None:
                budget -= req.n_flows
            if is_late:
                if not req.deferred:
                    self._late.inc()
                req = dataclasses.replace(req, release=floor)
            admitted.append(req)
        self._q = self._shed(keep, t_now)
        return admitted
