"""Online extension: coflows with release (arrival) times.

Port of ``repro.core.online``'s ordering, shared by every online entry point
of the engine. Coflow ``m`` becomes known at ``releases[m]``; its flows are
assigned at arrival, irrevocably, by the same greedy rule as offline, in
arrival order (ties broken by WSPT score), and each core schedules flows in
WSPT priority order, a flow eligible only at times ``t >= release``. The WSPT
score of a coflow never changes, so re-ranking the pending set at each
arrival equals one static ranking of all coflows by score; with all releases
0 the arrival order, the priority order and the offline order coincide.

:func:`run_online` is the reference's online oracle (``repro.core.online.
run_online``): the dataclass assignment at arrival and the per-core event
loops of ``circuit_scheduler``, op for op on the host. With all releases 0
it equals the offline ``scheduler.run`` bit for bit; ``engine.
cross_check_online`` holds ``run_fast_online`` to it.
"""
from __future__ import annotations

import numpy as np
import torch

from .assignment import (Assignment, assign_random, assign_rho_only,
                         assign_tau_aware)
from .circuit_scheduler import (ScheduledFlow, _run_list_scheduler,
                                schedule_core_list, schedule_core_reserving)
from .coflow import Instance, OnlineInstance
from .ordering import priority_scores
from .scheduler import ALGORITHMS, Schedule, _flat_schedule

__all__ = ["OnlineInstance", "online_orders", "run_online"]


def online_orders(inst: Instance, rel: torch.Tensor,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(arrival order, priority rank)``, both ``(M,)`` int64 on the
    instance's device.

    Arrival order: coflows sorted by ``(release, -score, index)``, the
    reference's ``np.lexsort((-s, rel))``, as two stable sorts (secondary
    key first). Priority rank: ``prio_rank[m]`` is coflow ``m``'s position in
    the WSPT order of all coflows (score descending, stable by index).
    """
    s = priority_scores(inst)
    rel = torch.as_tensor(rel, dtype=torch.float64, device=inst.device)
    by_score = torch.argsort(-s, stable=True)
    arrival = by_score[torch.argsort(rel[by_score], stable=True)]
    prio_rank = torch.empty(inst.M, dtype=torch.int64, device=inst.device)
    prio_rank[by_score] = torch.arange(inst.M, device=inst.device)
    return arrival, prio_rank


def _assign_at_arrival(inst: Instance, arrival: torch.Tensor, algorithm: str,
                       seed: int) -> tuple[Assignment, str | None]:
    """Per-arrival irrevocable assignment; returns (assignment, forced
    policy)."""
    if algorithm in ("ours", "sunflow-core"):
        a = assign_tau_aware(inst, arrival)
    elif algorithm == "rho-assign":
        a = assign_rho_only(inst, arrival)
    elif algorithm in ("rand-assign", "rand-sunflow"):
        a = assign_random(inst, arrival, seed=seed)
    else:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; one of {sorted(ALGORITHMS)}")
    forced = ("sunflow" if algorithm in ("sunflow-core", "rand-sunflow")
              else None)
    return a, forced


def run_online(
    oinst: OnlineInstance,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    scheduling: str = "work-conserving",
    assignment: Assignment | None = None,
) -> Schedule:
    """Online scheduling with arrivals, through the oracles.

    ``scheduling`` is the intra-core policy, as in ``scheduler.run``:
    ``work-conserving`` / ``priority-guard`` scan the pending *released*
    flows in WSPT priority order at every event; ``reserving`` commits
    reservations in arrival order, each no earlier than its release. The
    sunflow baselines serve one coflow at a time: whenever the core frees,
    the arrived unserved coflow of best WSPT rank is next (idling until the
    next arrival if none is pending).

    ``assignment`` (an :class:`Assignment` in arrival order) skips the
    assignment phase and schedules it instead: how ``engine.
    cross_check_online`` replays the engine's own choices. The result is a
    flat ``Schedule`` on the instance's device whose ``pi`` is the arrival
    order, with ``assignment`` set; ``simulator.validate(s, releases=)``
    checks it.
    """
    inst = oinst.inst
    rel = oinst.releases.detach().cpu().numpy()
    assert len(rel) == inst.M

    arrival, prio_rank = online_orders(inst, oinst.releases)
    if assignment is None:
        a, forced = _assign_at_arrival(inst, arrival, algorithm, seed)
    else:
        a = assignment
        forced = ("sunflow" if algorithm in ("sunflow-core", "rand-sunflow")
                  else None)
    sched = forced if forced is not None else scheduling
    arrival_h = arrival.cpu().numpy()
    rel_pos = rel[arrival_h]                     # release at arrival position
    prio_pos = prio_rank.cpu().numpy()[arrival_h]  # priority of that position
    rates = inst.rates.tolist()

    all_scheduled: list[ScheduledFlow] = []
    for k in range(inst.K):
        rate = rates[k]
        on_k = [af for per in a.flows for af in per if af.core == k]
        if sched in ("work-conserving", "priority-guard"):
            # WSPT priority scan order: coflow priority rank, then the
            # intra-coflow assignment (largest-first) order.
            on_k.sort(key=lambda af: prio_pos[af.flow.coflow])
            rel_f = np.array([rel_pos[af.flow.coflow] for af in on_k])
            all_scheduled.extend(schedule_core_list(
                on_k, k, rate, inst.delta, inst.N,
                guard=(sched == "priority-guard"), releases=rel_f))
        elif sched == "reserving":
            # Reservations are committed in arrival order (list order).
            rel_f = np.array([rel_pos[af.flow.coflow] for af in on_k])
            all_scheduled.extend(schedule_core_reserving(
                on_k, k, rate, inst.delta, inst.N, releases=rel_f))
        elif sched == "sunflow":
            all_scheduled.extend(_sunflow_core_online(
                on_k, k, rate, inst.delta, inst.N, rel_pos, prio_pos))
        else:
            raise ValueError(f"unknown scheduling {scheduling!r}")
    return _flat_schedule(inst, arrival, a, all_scheduled)


def _sunflow_core_online(
    flows: list,  # AssignedFlows of one core, arrival-major order
    core: int,
    rate: float,
    delta: float,
    n_ports: int,
    rel_pos: np.ndarray,
    prio_pos: np.ndarray,
) -> list[ScheduledFlow]:
    """Online SUNFLOW-CORE: coflow-at-a-time with WSPT pick-next on arrival.

    The core serves exactly one coflow at a time (a barrier between
    coflows); when it frees, the arrived unserved coflow with the best WSPT
    rank is next, idling until the next arrival if none is pending. With all
    releases 0 this is the offline ``schedule_core_sunflow``.
    """
    groups: dict[int, list] = {}
    for af in flows:
        groups.setdefault(af.flow.coflow, []).append(af)
    # insertion-ordered, so the ready scan is deterministic
    unserved = dict.fromkeys(groups)
    out: list[ScheduledFlow] = []
    barrier = 0.0
    while unserved:
        ready = [p for p in unserved if rel_pos[p] <= barrier]
        if not ready:
            barrier = min(float(rel_pos[p]) for p in unserved)
            ready = [p for p in unserved if rel_pos[p] <= barrier]
        pos = min(ready, key=lambda p: prio_pos[p])
        del unserved[pos]
        grp = sorted(groups[pos], key=lambda af: (-af.flow.size, af.flow.i,
                                                  af.flow.j))
        fi = np.array([af.flow.i for af in grp], dtype=np.int64)
        fj = np.array([af.flow.j for af in grp], dtype=np.int64)
        sizes = np.array([af.flow.size for af in grp], dtype=np.float64)
        t_est = _run_list_scheduler(fi, fj, sizes, rate, delta, n_ports,
                                    t0=barrier, guard=True)
        for idx, af in enumerate(grp):
            te = float(t_est[idx])
            tc = te + delta + af.flow.size / rate
            out.append(ScheduledFlow(
                coflow=af.flow.coflow, cid=af.flow.cid, i=af.flow.i,
                j=af.flow.j, core=core, size=af.flow.size, t_establish=te,
                t_start=te + delta, t_complete=tc))
            barrier = max(barrier, tc)
    return out
