"""Intra-core circuit scheduling under the not-all-stop model (Alg. 1, lines
18-32): the reference's per-core oracles.

Port of ``repro.core.circuit_scheduler``, op for op in host numpy fp64 with
the same ``heapq`` events and the same exact float comparisons (a port is
free at event ``t`` iff ``free <= t``, a flow is released iff
``release <= t``). The per-core policy is port-exclusive, non-preemptive and
work-conserving and respects the global order pi: an event-driven list
scheduler that, whenever a port frees (or at t=0), scans the pending flows
in priority order and establishes every flow whose two ports are idle
(occupying both for ``delta + size/rate``).

``schedule_core_sunflow`` is Sunflow's coflow-at-a-time behaviour
(SUNFLOW-CORE baseline): coflows strictly one after another on the core,
each coflow's flows largest first through the priority-guarded scan.

These loops rescan every pending flow at every event, on purpose: they are
the simple second implementation that ``engine.cross_check`` holds the
engine's merged loops to. Their inputs are lists of
``assignment.AssignedFlow`` records and their outputs lists of
:class:`ScheduledFlow`, all host objects.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

__all__ = [
    "ScheduledFlow",
    "schedule_core_list",
    "schedule_core_sunflow",
    "schedule_core_reserving",
]


@dataclasses.dataclass(frozen=True)
class ScheduledFlow:
    coflow: int     # position in global order pi
    cid: int        # original coflow id
    i: int
    j: int
    core: int
    size: float
    t_establish: float  # circuit establishment begins (ports become busy)
    t_start: float      # transmission begins = t_establish + delta
    t_complete: float   # t_establish + delta + size/rate


def _run_list_scheduler(
    fi: np.ndarray,
    fj: np.ndarray,
    sizes: np.ndarray,
    rate: float,
    delta: float,
    n_ports: int,
    t0: float = 0.0,
    guard: bool = True,
    releases: np.ndarray | None = None,
) -> np.ndarray:
    """Core event loop. Flows are given in priority order; returns t_establish.

    ``guard=True`` implements the paper's work-conservation wording literally
    ("when there are NO higher-priority flows on a port pair, lower-priority
    flows can be processed"): a pending higher-priority flow *protects* its
    two ports, so lower-priority flows cannot backfill onto them. Without the
    guard (guard=False) any feasible flow starts immediately — greedier, but
    a long low-priority flow can occupy a port a high-priority flow needs
    next, which is how the Lemma 3 bound gets violated in practice.

    ``releases`` (per flow, aligned with ``fi``) gates eligibility on arrival
    times: a flow may establish only at events ``t >= releases[f]``. All
    comparisons are exact (``release <= t``, ``free <= t``); release times
    are seeded into the event heap so eligibility flips exactly at the
    release instant. An unreleased flow is invisible to the scheduler: under
    ``guard=True`` it does NOT protect its ports (the online scheduler cannot
    know flows that have not arrived).
    """
    F = len(sizes)
    t_est = np.full(F, -1.0)
    if F == 0:
        return t_est
    free_in = np.full(n_ports, t0)
    free_out = np.full(n_ports, t0)
    done = np.zeros(F, dtype=bool)
    remaining = F
    events: list[float] = [t0]
    if releases is not None:
        events.extend(float(r) for r in np.unique(releases))
    heapq.heapify(events)
    seen_times: set[float] = set(events)

    while remaining:
        if not events:
            raise RuntimeError("scheduler deadlock: pending flows but no events")
        t = heapq.heappop(events)
        while events and events[0] == t:
            heapq.heappop(events)
        # Candidates whose ports are currently free, in priority order.
        pend = np.nonzero(~done)[0]
        blocked_in = np.zeros(n_ports, dtype=bool)
        blocked_out = np.zeros(n_ports, dtype=bool)
        for f in pend:
            if releases is not None and releases[f] > t:
                continue  # not yet arrived: cannot start, cannot protect
            i, j = fi[f], fj[f]
            if (free_in[i] <= t and free_out[j] <= t
                    and not blocked_in[i] and not blocked_out[j]):
                t_est[f] = t
                tc = t + delta + sizes[f] / rate
                free_in[i] = tc
                free_out[j] = tc
                done[f] = True
                remaining -= 1
                if tc not in seen_times:
                    seen_times.add(tc)
                    heapq.heappush(events, tc)
            elif guard:
                # a pending higher-priority flow protects its port pair
                blocked_in[i] = True
                blocked_out[j] = True
    return t_est


def schedule_core_list(
    flows: list,  # list[AssignedFlow] for one core, in global priority order
    core: int,
    rate: float,
    delta: float,
    n_ports: int,
    guard: bool = False,
    releases: np.ndarray | None = None,
) -> list[ScheduledFlow]:
    """The paper's work-conserving priority list scheduler for one core
    (Alg. 1 lines 23-31, literal: any flow whose two ports are idle starts).

    ``guard=True`` is the priority-guarded variant (pending higher-priority
    flows protect their port pairs). The reference's reproduction finding:
    the guard hurts (about 2x worse weighted CCT on trace workloads) and
    still does not restore Lemma 3.

    ``releases`` (per flow, aligned with ``flows``) adds online release
    gating — see ``_run_list_scheduler``.
    """
    fi = np.array([af.flow.i for af in flows], dtype=np.int64)
    fj = np.array([af.flow.j for af in flows], dtype=np.int64)
    sizes = np.array([af.flow.size for af in flows], dtype=np.float64)
    t_est = _run_list_scheduler(fi, fj, sizes, rate, delta, n_ports, guard=guard,
                                releases=releases)
    out = []
    for idx, af in enumerate(flows):
        te = float(t_est[idx])
        out.append(
            ScheduledFlow(
                coflow=af.flow.coflow,
                cid=af.flow.cid,
                i=af.flow.i,
                j=af.flow.j,
                core=core,
                size=af.flow.size,
                t_establish=te,
                t_start=te + delta,
                t_complete=te + delta + af.flow.size / rate,
            )
        )
    return out


def schedule_core_reserving(
    flows: list,  # list[AssignedFlow] for one core, in global priority order
    core: int,
    rate: float,
    delta: float,
    n_ports: int,
    releases: np.ndarray | None = None,
) -> list[ScheduledFlow]:
    """Alternative reading of Alg. 1 lines 23-31: sequential reservation.

    Flows are committed strictly in pi order; each starts at the earliest time
    both its ports are free given prior reservations, with no backfilling of
    lower-priority flows into gaps. Neither this nor the work-conserving
    policy satisfies Lemma 3 on all adversarial instances.

    ``releases`` (per flow): online variant — flows are committed in the
    given (arrival) order and each reservation additionally starts no
    earlier than the flow's release time.
    """
    avail_in = np.zeros(n_ports)
    avail_out = np.zeros(n_ports)
    out = []
    for idx, af in enumerate(flows):
        i, j, d = af.flow.i, af.flow.j, af.flow.size
        t = float(max(avail_in[i], avail_out[j]))
        if releases is not None and releases[idx] > t:
            t = float(releases[idx])
        tc = t + delta + d / rate
        avail_in[i] = tc
        avail_out[j] = tc
        out.append(
            ScheduledFlow(
                coflow=af.flow.coflow,
                cid=af.flow.cid,
                i=i,
                j=j,
                core=core,
                size=d,
                t_establish=t,
                t_start=t + delta,
                t_complete=tc,
            )
        )
    return out


def schedule_core_sunflow(
    flows: list,  # list[AssignedFlow] for one core, in global priority order
    core: int,
    rate: float,
    delta: float,
    n_ports: int,
) -> list[ScheduledFlow]:
    """SUNFLOW-CORE: serve coflows one at a time (barrier between coflows)."""
    out: list[ScheduledFlow] = []
    barrier = 0.0
    # Group by coflow position, preserving pi order.
    groups: dict[int, list] = {}
    for af in flows:
        groups.setdefault(af.flow.coflow, []).append(af)
    for pos in sorted(groups):
        grp = groups[pos]
        # Sunflow schedules a single coflow's flows longest-first.
        grp = sorted(grp, key=lambda af: (-af.flow.size, af.flow.i, af.flow.j))
        fi = np.array([af.flow.i for af in grp], dtype=np.int64)
        fj = np.array([af.flow.j for af in grp], dtype=np.int64)
        sizes = np.array([af.flow.size for af in grp], dtype=np.float64)
        t_est = _run_list_scheduler(fi, fj, sizes, rate, delta, n_ports,
                                    t0=barrier, guard=True)
        for idx, af in enumerate(grp):
            te = float(t_est[idx])
            tc = te + delta + af.flow.size / rate
            out.append(
                ScheduledFlow(
                    coflow=af.flow.coflow,
                    cid=af.flow.cid,
                    i=af.flow.i,
                    j=af.flow.j,
                    core=core,
                    size=af.flow.size,
                    t_establish=te,
                    t_start=te + delta,
                    t_complete=tc,
                )
            )
            barrier = max(barrier, tc)
    return out
