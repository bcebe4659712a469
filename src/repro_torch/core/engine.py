"""Algorithm 1 and its ablation end to end: flat flow table, assignment,
event loops, offline and online.

Port of the one-shot paths of ``repro.core.engine``. The pipeline of
:func:`run_fast` (and of :func:`run_fast_online`, with the arrival order in
place of pi) is

  1. WSPT order pi (online: arrival order) and flow extraction, on the
     device (``ordering``, ``online.online_orders``, ``coflow.extract_flows``);
  2. cross-core assignment: the fp64 host backend (``assignment``) under
     ``backend="numpy"``, the default as in the reference, or the tau-aware
     CUDA kernel (``kernels.ops.coflow_assign``) under ``backend="kernel"``;
  3. service times on the device, then the circuit event loops on the host:
     the flow table goes to the host once and the establishment times come
     back once;
  4. CCTs on the device (``scatter_reduce(..., "amax")``).

The event loops stay host code over numpy arrays, in a copy the port owns.
They are sequential logic with no kernel in the reference, they rely on
numpy's last-write-wins fancy assignment with duplicate indices
(``_first_occurrence``; torch's ``index_put_`` leaves that order undefined),
and they run per-event operations on tiny arrays, where torch's per-call
overhead would dominate. Moving them onto the card is later work.

Completion times keep the reference's float associativity,
``(t + delta) + size/rate``, so establishment times and CCTs are
bit-identical to the reference given the same core choices.

The differential gates are here too: :func:`cross_check` and
:func:`cross_check_online` hold the engine to the reference's oracles
(``scheduler.run``'s per-core loops, ``online.run_online``) and to the
referee, and :func:`schedule_all_cores` schedules a dataclass
``Assignment`` through the engine.
"""
from __future__ import annotations

import dataclasses
import heapq
from functools import partial

import numpy as np
import torch

from repro_torch.kernels.ops import coflow_assign
from repro_torch.kernels.ref import assign_ref

from .assignment import (Assignment, FlatAssignState, _host_f64, assign_fast,
                         assign_random, assign_rho_only, assign_tau_aware,
                         assignment_from_choices)
from .circuit_scheduler import (schedule_core_list, schedule_core_reserving,
                                schedule_core_sunflow)
from .coflow import Instance, OnlineInstance, extract_flows
from .online import online_orders, run_online
from .ordering import order_coflows
from .scheduler import (ALGORITHMS, Schedule, _schedule_from_assignment,
                        scheduled_flows)
from .simulator import validate

__all__ = ["ALGORITHMS", "BACKENDS", "FlowTable", "SCHEDULINGS",
           "build_flow_table", "schedule_all_cores", "run_fast",
           "run_fast_metrics", "run_fast_online", "cross_check",
           "cross_check_online"]

#: Intra-core policies. ``sunflow`` is the coflow-at-a-time policy of the
#: SUNFLOW-CORE baselines.
SCHEDULINGS = ("work-conserving", "priority-guard", "reserving", "sunflow")

#: Assignment backends. ``numpy`` (the default, as in the reference) runs
#: the fp64 host backend, bit-identical to the reference's oracles;
#: ``kernel`` (opt-in, the latency path) runs the tau-aware policy on the
#: CUDA kernel (fp32 state, the reference's ``"pallas"``). The rho-only and
#: random policies have no kernel and always run the host backend.
BACKENDS = ("numpy", "kernel")

#: algorithm name -> assignment policy.
_POLICY_OF = {
    "ours": "tau-aware",
    "sunflow-core": "tau-aware",
    "rho-assign": "rho-only",
    "rand-assign": "random",
    "rand-sunflow": "random",
}


@dataclasses.dataclass(frozen=True)
class FlowTable:
    """All assigned flows of an instance as flat ``(F,)`` tensors, in global
    pi order, on the instance's device."""

    pos: torch.Tensor   # coflow position in pi, int64
    cid: torch.Tensor   # original coflow id, int64
    fi: torch.Tensor    # ingress port, int64
    fj: torch.Tensor    # egress port, int64
    core: torch.Tensor  # assigned core, int64
    size: torch.Tensor  # float64

    @classmethod
    def from_assignment(cls, assignment: Assignment) -> "FlowTable":
        """The flows of a dataclass ``Assignment``, in its order, on its
        instance's device."""
        rows = [(af.flow.coflow, af.flow.cid, af.flow.i, af.flow.j, af.core,
                 af.flow.size) for per in assignment.flows for af in per]
        cols = list(zip(*rows)) or [()] * 6
        dev = assignment.inst.device
        ints = [torch.tensor(c, dtype=torch.int64, device=dev)
                for c in cols[:5]]
        return cls(*ints, size=torch.tensor(cols[5], dtype=torch.float64,
                                             device=dev))

    @property
    def n_flows(self) -> int:
        return int(self.pos.shape[0])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _resolve_algorithm(algorithm: str, scheduling: str) -> tuple[str, str]:
    """(assignment policy, effective scheduling) for an algorithm name."""
    if algorithm not in _POLICY_OF:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; one of {sorted(ALGORITHMS)}")
    if algorithm in ("sunflow-core", "rand-sunflow"):
        scheduling = "sunflow"
    return _POLICY_OF[algorithm], scheduling


def build_flow_table(
    inst: Instance,
    pi: torch.Tensor,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    backend: str = "numpy",
    delta_k: torch.Tensor | np.ndarray | None = None,
    locality: float = 0.0,
) -> FlowTable:
    """Demand tensor -> assigned ``FlowTable``, on the instance's device.

    Extracts the flows in pi order and assigns them with the policy of
    ``algorithm``, choosing the implementation exactly as the reference
    does:

      - a drifted tau-aware run (``delta_k`` differs from ``inst.delta`` on
        some core) goes to :class:`FlatAssignState` with ``set_delta``, since
        the kernel prices the nominal delta only;
      - ``backend="kernel"``, tau-aware and ``locality == 0`` goes to the
        kernel (on the CPU, its plain version), choices equal to the
        reference's ``backend="pallas"``;
      - everything else goes to :func:`assignment.assign_fast`, choices equal
        to the reference's ``backend="numpy"``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if delta_k is not None:
        delta_k = _host_f64(delta_k)
        if delta_k.shape != (inst.K,):
            raise ValueError(
                f"delta_k must have shape ({inst.K},), got {delta_k.shape}")
    policy, _ = _resolve_algorithm(algorithm, "")
    flows = extract_flows(inst, pi)
    pos, cid, fi, fj, size = flows
    if (policy == "tau-aware" and delta_k is not None
            and bool(np.any(delta_k != inst.delta))):
        st = FlatAssignState(policy, inst.rates, inst.delta, inst.N,
                             seed=seed, locality=locality)
        for k in range(inst.K):
            if delta_k[k] != inst.delta:
                st.set_delta(k, float(delta_k[k]))
        core = st.assign(fi, fj, size)
    elif backend == "kernel" and policy == "tau-aware" and not locality:
        core = coflow_assign(fi, fj, size, inst.rates, inst.delta,
                             n_ports=inst.N).to(torch.int64)
    else:
        core = assign_fast(inst, pi, policy, seed=seed, flows=flows,
                           locality=locality)
    return FlowTable(pos=pos, cid=cid, fi=fi, fj=fj, core=core, size=size)


def _first_occurrence(vals: np.ndarray, scratch: np.ndarray) -> np.ndarray:
    """Boolean mask marking the first occurrence of each value, in order.

    Writing positions in reverse leaves each slot of ``scratch`` holding the
    *first* position of its value (numpy's fancy assignment keeps the last
    write), so a flow is first on its resource iff the slot points back at
    it. ``scratch`` is int64 with at least ``vals.max() + 1`` entries.
    """
    n = vals.size
    scratch[vals[::-1]] = np.arange(n - 1, -1, -1)
    return scratch[vals] == np.arange(n)


def _by_resource(res_ids: np.ndarray, n_res: int) -> list[np.ndarray]:
    """Flow indices using each resource, in priority (index) order."""
    order = np.argsort(res_ids, kind="stable")
    counts = np.bincount(res_ids, minlength=n_res)
    return np.split(order, np.cumsum(counts)[:-1])


def _pop_next_event(events: list[float], t: float) -> float:
    """Earliest completion strictly after t (``events`` is a heap)."""
    while events and events[0] <= t:
        heapq.heappop(events)
    if not events:
        raise RuntimeError("scheduler deadlock: pending flows but no events")
    return heapq.heappop(events)


def _event_loop(
    rin: np.ndarray,    # (F,) int64 ingress resource ids (core*N + i)
    rout: np.ndarray,   # (F,) int64 egress resource ids (core*N + j)
    srv: np.ndarray,    # (F,) float64 service times size/rate[core]
    core: np.ndarray,   # (F,) int64
    delta: float | np.ndarray,
    n_res: int,
    n_ports: int,
    t0: float = 0.0,
    guard: bool = False,
    release: np.ndarray | None = None,
    free_in0: np.ndarray | None = None,
    free_out0: np.ndarray | None = None,
) -> np.ndarray:
    """Merged event loop over all cores; flows in priority order.

    Returns t_establish per flow, exactly as the reference's sequential
    list scan: at each event the started set is {flows whose two resources
    are free and which are the first pending user of both}, iterated to a
    fixed point for ``guard=False`` (work-conserving), single-pass for
    ``guard=True`` (priority-guard: a pending higher-priority flow holds
    both its resources whether or not it starts).

    Work-conserving: after each event's fixed point every pending flow has
    a busy resource or an unreached release, so only flows on resources
    freed exactly at the next event, or released exactly then, can start;
    candidates come from those resources' flow lists and the release lists.
    ``release`` (per flow) gates eligibility by the exact comparison
    ``release <= t``; an unreleased flow never protects its ports under
    ``guard=True``. Event times are copied verbatim from completion and
    release times, so the exact float comparisons below are the convention,
    not a hazard. ``t0`` is the time the resources free (the sunflow
    barrier). ``delta`` is a scalar or a per-flow array (drifted cores).

    ``free_in0``/``free_out0`` (per resource, both or neither) seed the port
    horizons from circuits already committed by earlier service ticks
    (``fabric.FabricState``): every horizon strictly after ``t0`` goes into
    the event heap, so the loop wakes when a committed circuit tears down;
    ``+inf`` horizons (a failed core's resources) are never seeded. With
    ``None`` this is the from-scratch loop.
    """
    F = rin.size
    t_est = np.full(F, -1.0)
    if F == 0:
        return t_est
    d_vec = None if np.ndim(delta) == 0 else np.asarray(delta, dtype=np.float64)
    if free_in0 is None:
        free_in = np.full(n_res, t0)
        free_out = np.full(n_res, t0)
    else:
        free_in = np.asarray(free_in0, dtype=np.float64).copy()
        free_out = np.asarray(free_out0, dtype=np.float64).copy()
    done = np.zeros(F, dtype=bool)
    scratch = np.empty(n_res, dtype=np.int64)
    events: list[float] = []  # heap of future completion and release times
    if free_in0 is not None:
        seed_in = free_in[(free_in > t0) & np.isfinite(free_in)]
        seed_out = free_out[(free_out > t0) & np.isfinite(free_out)]
        events = np.unique(np.concatenate([seed_in, seed_out])).tolist()
    remaining = F
    t = t0
    if release is not None:
        rel_uniq, rel_inv = np.unique(release, return_inverse=True)
        events.extend(rel_uniq.tolist())
        heapq.heapify(events)
        # flow indices grouped by release value, in priority order
        rel_lists = np.split(np.argsort(rel_inv, kind="stable"),
                             np.cumsum(np.bincount(rel_inv))[:-1])
        rel_map = {float(v): lst for v, lst in zip(rel_uniq, rel_lists)}

    if guard:
        pending = np.arange(F)
        first_event = True
        while remaining:
            if first_event:
                pend = pending
                first_event = False
            else:
                # Only cores with a completion (or a release) at t can
                # start flows now.
                act = np.zeros(n_res // n_ports, dtype=bool)
                act[np.nonzero(free_in == t)[0] // n_ports] = True  # reprolint: disable=float-eq -- exact-float convention: t was copied verbatim from free_in (circuit_scheduler docstring)
                act[np.nonzero(free_out == t)[0] // n_ports] = True  # reprolint: disable=float-eq -- exact-float convention: t was copied verbatim from free_out
                if release is not None:
                    act[core[pending[release[pending] == t]]] = True  # reprolint: disable=float-eq -- exact-float convention: event times are copied release values, never arithmetic
                pend = pending[act[core[pending]]]
            if release is not None and pend.size:
                pend = pend[release[pend] <= t]
            if pend.size:
                ri, rj = rin[pend], rout[pend]
                feas = ((free_in[ri] <= t) & (free_out[rj] <= t)
                        & _first_occurrence(ri, scratch)
                        & _first_occurrence(rj, scratch))
                start = pend[feas]
                if start.size:
                    tc = (t + (delta if d_vec is None else d_vec[start])) \
                        + srv[start]
                    free_in[rin[start]] = tc
                    free_out[rout[start]] = tc
                    t_est[start] = t
                    done[start] = True
                    remaining -= start.size
                    for v in tc.tolist():
                        heapq.heappush(events, v)
                    pending = pending[~done[pending]]
                    if not remaining:
                        break
            t = _pop_next_event(events, t)
        return t_est

    in_lists = _by_resource(rin, n_res)
    out_lists = _by_resource(rout, n_res)
    cand = np.arange(F)  # at t0 every (released) flow is a candidate
    if release is not None:
        cand = cand[release[cand] <= t]
    while remaining:
        cand = cand[(free_in[rin[cand]] <= t) & (free_out[rout[cand]] <= t)]
        while cand.size:
            safe = _first_occurrence(rin[cand], scratch) \
                & _first_occurrence(rout[cand], scratch)
            start = cand[safe]
            tc = (t + (delta if d_vec is None else d_vec[start])) + srv[start]
            free_in[rin[start]] = tc
            free_out[rout[start]] = tc
            t_est[start] = t
            done[start] = True
            remaining -= start.size
            for v in tc.tolist():
                heapq.heappush(events, v)
            cand = cand[~safe]
            cand = cand[(free_in[rin[cand]] <= t) & (free_out[rout[cand]] <= t)]
        if not remaining:
            break
        t = _pop_next_event(events, t)
        pool = [in_lists[r] for r in np.nonzero(free_in == t)[0]]  # reprolint: disable=float-eq -- exact-float convention: t is popped verbatim from the event heap fed by free_in
        pool += [out_lists[r] for r in np.nonzero(free_out == t)[0]]  # reprolint: disable=float-eq -- exact-float convention: t is popped verbatim from the event heap fed by free_out
        if release is not None:
            pool.append(rel_map.get(t, np.empty(0, np.int64)))
        cand = np.unique(np.concatenate(pool)) if pool else np.empty(0, np.int64)
        cand = cand[~done[cand]]
        if release is not None:
            cand = cand[release[cand] <= t]
    return t_est


def _reserving_times(rin: np.ndarray, rout: np.ndarray, srv: np.ndarray,
                     delta: float | np.ndarray, n_res: int,
                     release: np.ndarray | None = None,
                     avail_in: np.ndarray | None = None,
                     avail_out: np.ndarray | None = None) -> np.ndarray:
    """Strict in-order reservation (no backfill) over merged resources.

    ``release`` (per flow) is the online variant: flows come in commitment
    (arrival) order and each reservation starts no earlier than its
    release. ``delta`` may be a per-flow array (drifted cores).

    ``avail_in``/``avail_out`` (both or neither) carry the reservation
    horizons across service ticks and are MUTATED in place: a reservation
    never moves once made, so the arrays are the committed state.
    """
    d_vec = None if np.ndim(delta) == 0 else np.asarray(delta, dtype=np.float64)
    if avail_in is None:
        avail_in = np.zeros(n_res)
        avail_out = np.zeros(n_res)
    t_est = np.empty(rin.size)
    for f in range(rin.size):
        i, j = rin[f], rout[f]
        t = avail_in[i] if avail_in[i] >= avail_out[j] else avail_out[j]
        if release is not None and release[f] > t:
            t = release[f]
        tc = t + (delta if d_vec is None else d_vec[f]) + srv[f]
        avail_in[i] = tc
        avail_out[j] = tc
        t_est[f] = t
    return t_est


def _sunflow_times(
    pos: np.ndarray,    # (F,) int64, the flow table's columns on the host
    core: np.ndarray,
    fi: np.ndarray,
    fj: np.ndarray,
    size: np.ndarray,
    rin: np.ndarray,
    rout: np.ndarray,
    srv: np.ndarray,
    delta: float,
    n_ports: int,
    K: int,
    release: np.ndarray | None = None,
    prio: np.ndarray | None = None,
    delta_k: np.ndarray | None = None,
) -> np.ndarray:
    """SUNFLOW-CORE: per core, coflows strictly one after another (a
    barrier), the flows of one coflow largest first with an ``(i, j)``
    tie-break, through the priority-guarded scan.

    ``release``/``prio`` (per flow; a coflow's flows share both) select the
    online variant: whenever the core frees, the arrived unserved coflow of
    best priority rank is served next, idling until the next arrival if
    none is pending. ``delta_k`` replaces ``delta`` core by core.
    """
    t_est = np.full(pos.size, -1.0)
    idx = np.arange(pos.size)
    for k in range(K):
        dk = delta if delta_k is None else float(delta_k[k])
        on_k = idx[core == k]
        barrier = 0.0
        if release is None:
            serve_order = list(np.unique(pos[on_k]))  # pi order
        else:
            rel_of = {int(pos[f]): float(release[f]) for f in on_k}
            prio_of = {int(pos[f]): int(prio[f]) for f in on_k}
            # insertion-ordered, so the ready scan below is deterministic
            unserved = dict.fromkeys(rel_of)
        while True:
            if release is None:
                if not serve_order:
                    break
                p = serve_order.pop(0)
            else:
                if not unserved:
                    break
                ready = [q for q in unserved if rel_of[q] <= barrier]
                if not ready:
                    barrier = min(rel_of[q] for q in unserved)
                    ready = [q for q in unserved if rel_of[q] <= barrier]
                p = min(ready, key=lambda q: prio_of[q])
                del unserved[p]
            grp = on_k[pos[on_k] == p]
            grp = grp[np.lexsort((fj[grp], fi[grp], -size[grp]))]
            te = _event_loop(rin[grp], rout[grp], srv[grp], core[grp], dk,
                             n_res=K * n_ports, n_ports=n_ports, t0=barrier,
                             guard=True)
            t_est[grp] = te
            barrier = max(barrier, float(((te + dk) + srv[grp]).max()))
    return t_est


def _times_for_table(
    inst: Instance,
    pi: torch.Tensor,
    table: FlowTable,
    scheduling: str = "work-conserving",
    releases: torch.Tensor | None = None,
    delta_k: np.ndarray | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scheduling phase over a ``FlowTable``: ``(t_est, srv)`` on the device.

    Resource ids, service times and the online keys are computed on the
    device; the loops run on host copies and the establishment times go
    back in one copy. ``releases`` (``(M,)``, by original coflow id) selects
    the online model: the scheduling priority is each coflow's WSPT rank
    (``online.online_orders``), eligibility is release-gated, and reserving
    and sunflow run their online variants. ``delta_k`` (already normalized:
    ``None`` when undrifted) replaces ``inst.delta`` by ``delta_k[core]``
    per flow.
    """
    if scheduling not in SCHEDULINGS:
        raise ValueError(
            f"unknown scheduling {scheduling!r}; one of {SCHEDULINGS}")
    K, N = inst.K, inst.N
    srv = table.size / inst.rates[table.core]
    rin = _host(table.core * N + table.fi)
    rout = _host(table.core * N + table.fj)
    core, srv_h = _host(table.core), _host(srv)
    dl = inst.delta if delta_k is None else delta_k[core]
    if scheduling == "sunflow":
        cols = tuple(_host(t) for t in (table.pos, table.core, table.fi,
                                        table.fj, table.size))
    if releases is None:
        if scheduling == "reserving":
            t_est = _reserving_times(rin, rout, srv_h, dl, K * N)
        elif scheduling == "sunflow":
            t_est = _sunflow_times(*cols, rin, rout, srv_h, inst.delta, N, K,
                                   delta_k=delta_k)
        else:
            t_est = _event_loop(rin, rout, srv_h, core, dl, K * N, N,
                                guard=(scheduling == "priority-guard"))
    else:
        rel_orig = torch.as_tensor(releases, dtype=torch.float64,
                                   device=inst.device)
        orig = pi[table.pos]
        _, prio_rank = online_orders(inst, rel_orig)
        rel_f, prio_f = _host(rel_orig[orig]), prio_rank[orig]
        if scheduling in ("work-conserving", "priority-guard"):
            # Flows in scheduling-priority order: WSPT coflow rank, then the
            # intra-coflow assignment order (stable).
            perm = _host(torch.argsort(prio_f, stable=True))
            te = _event_loop(rin[perm], rout[perm], srv_h[perm], core[perm],
                             dl if delta_k is None else dl[perm], K * N, N,
                             guard=(scheduling == "priority-guard"),
                             release=rel_f[perm])
            t_est = np.empty_like(te)
            t_est[perm] = te
        elif scheduling == "reserving":
            # commitment in arrival order, the flow table's own order
            t_est = _reserving_times(rin, rout, srv_h, dl, K * N,
                                     release=rel_f)
        else:
            t_est = _sunflow_times(*cols, rin, rout, srv_h, inst.delta, N, K,
                                   release=rel_f, prio=_host(prio_f),
                                   delta_k=delta_k)
    return torch.from_numpy(t_est).to(inst.device), srv


def _ccts_from_times(inst: Instance, pi: torch.Tensor, table: FlowTable,
                     t_est: torch.Tensor, srv: torch.Tensor,
                     delta_f: torch.Tensor | None = None) -> torch.Tensor:
    """Per-coflow CCTs ``(M,)`` in original id order, on the device.
    ``delta_f`` is the per-flow delay in force (drifted cores); ``None`` is
    the uniform ``inst.delta`` with the undrifted float expression."""
    t_complete = (t_est + (inst.delta if delta_f is None else delta_f)) + srv
    ccts = torch.zeros(inst.M, dtype=torch.float64, device=inst.device)
    return ccts.scatter_reduce(0, pi[table.pos], t_complete, "amax")


def _schedule_from_times(inst: Instance, pi: torch.Tensor, table: FlowTable,
                         t_est: torch.Tensor, srv: torch.Tensor,
                         delta_f: torch.Tensor | None = None,
                         assignment: Assignment | None = None) -> Schedule:
    """Rows in the reference's order: core-major, priority order within
    each core."""
    order = torch.argsort(table.core, stable=True)
    te = t_est[order]
    t_start = te + (inst.delta if delta_f is None else delta_f[order])
    return Schedule(inst=inst, pi=pi, pos=table.pos[order],
                    cid=table.cid[order], fi=table.fi[order],
                    fj=table.fj[order], core=table.core[order],
                    size=table.size[order], t_establish=te, t_start=t_start,
                    t_complete=t_start + srv[order],
                    ccts=_ccts_from_times(inst, pi, table, t_est, srv,
                                          delta_f),
                    assignment=assignment)


def schedule_all_cores(
    inst: Instance,
    pi: torch.Tensor,
    assignment: Assignment,
    scheduling: str = "work-conserving",
    *,
    releases: torch.Tensor | np.ndarray | None = None,
) -> Schedule:
    """Schedule every flow of a dataclass ``Assignment`` on all K cores in
    one engine call.

    The engine counterpart of ``scheduler._schedule_from_assignment``: the
    same rows (core-major, priority order within a core) and establishment
    times bit for bit, with ``assignment`` set, so the theory certificates
    apply. ``releases`` selects the online semantics of
    :func:`_times_for_table`.
    """
    pi = torch.as_tensor(pi, dtype=torch.int64, device=inst.device)
    table = FlowTable.from_assignment(assignment)
    t_est, srv = _times_for_table(inst, pi, table, scheduling, releases)
    return _schedule_from_times(inst, pi, table, t_est, srv,
                                assignment=assignment)


def _normalize_delta_k(inst: Instance, delta_k: torch.Tensor | np.ndarray | None,
                       ) -> np.ndarray | None:
    """Validate a per-core delay vector (a host float64 array); an
    all-nominal vector becomes ``None`` so the undrifted pipeline keeps its
    exact scalar float expressions."""
    if delta_k is None:
        return None
    delta_k = _host_f64(delta_k)
    if delta_k.shape != (inst.K,):
        raise ValueError(
            f"delta_k must have shape ({inst.K},), got {delta_k.shape}")
    if (delta_k < 0).any():
        raise ValueError("drifted delta must be >= 0")
    if np.all(delta_k == inst.delta):
        return None
    return delta_k


def _delta_f(inst: Instance, table: FlowTable,
             delta_k: np.ndarray | None) -> torch.Tensor | None:
    if delta_k is None:
        return None
    return torch.tensor(delta_k, device=inst.device)[table.core]


def run_fast(
    inst: Instance,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    scheduling: str = "work-conserving",
    backend: str = "numpy",
    delta_k: torch.Tensor | np.ndarray | None = None,
    locality: float = 0.0,
) -> Schedule:
    """Algorithm 1 (or a baseline of its ablation), offline, on the
    instance's device: the port of ``repro.core.run_fast``, with the same
    choices, establishment times and CCTs as the reference's ``"pallas"``
    backend under ``backend="kernel"`` and its ``"numpy"`` backend under
    ``backend="numpy"``.

    ``algorithm`` is one of :data:`ALGORITHMS`; the sunflow baselines always
    schedule with ``sunflow``. ``scheduling`` is ``work-conserving``
    (Alg. 1 lines 23-31), ``priority-guard`` (pending higher-priority flows
    protect their ports from backfill), ``reserving`` (strict in-order
    reservation) or ``sunflow``. ``seed`` seeds the random policy.
    ``delta_k`` (per-core drifted delays) prices assignment and scheduling
    with each core's delay; ``locality`` is the tau-aware batch-affinity
    bias. Either one runs the fp64 host backend.
    """
    delta_k = _normalize_delta_k(inst, delta_k)
    pi = order_coflows(inst)
    _, scheduling = _resolve_algorithm(algorithm, scheduling)
    table = build_flow_table(inst, pi, algorithm, seed=seed, backend=backend,
                             delta_k=delta_k, locality=locality)
    t_est, srv = _times_for_table(inst, pi, table, scheduling,
                                  delta_k=delta_k)
    return _schedule_from_times(inst, pi, table, t_est, srv,
                                _delta_f(inst, table, delta_k))


def run_fast_metrics(
    inst: Instance,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    scheduling: str = "work-conserving",
    backend: str = "numpy",
    releases: torch.Tensor | np.ndarray | None = None,
    delta_k: torch.Tensor | np.ndarray | None = None,
    locality: float = 0.0,
) -> tuple[torch.Tensor, int]:
    """The pipeline of :func:`run_fast` (``releases=None``) or
    :func:`run_fast_online` (``releases`` ``(M,)`` by original coflow id),
    stopped at the CCTs: returns ``(ccts (M,), n_flows)`` without building a
    ``Schedule``."""
    if releases is None:
        pi = order_coflows(inst)
    else:
        releases = torch.as_tensor(releases, dtype=torch.float64,
                                   device=inst.device)
        pi, _ = online_orders(inst, releases)
    delta_k = _normalize_delta_k(inst, delta_k)
    _, scheduling = _resolve_algorithm(algorithm, scheduling)
    table = build_flow_table(inst, pi, algorithm, seed=seed, backend=backend,
                             delta_k=delta_k, locality=locality)
    t_est, srv = _times_for_table(inst, pi, table, scheduling, releases,
                                  delta_k=delta_k)
    return (_ccts_from_times(inst, pi, table, t_est, srv,
                             _delta_f(inst, table, delta_k)), table.n_flows)


def run_fast_online(
    oinst: OnlineInstance,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    scheduling: str = "work-conserving",
    backend: str = "numpy",
    delta_k: torch.Tensor | np.ndarray | None = None,
    locality: float = 0.0,
) -> Schedule:
    """The online model on the instance's device: the port of
    ``repro.core.run_fast_online``.

    The pipeline of :func:`run_fast` with the arrival order in place of pi:
    flows are assigned at arrival, irrevocably, by the same greedy rule over
    the arrival-ordered flows (under ``backend="kernel"`` the tau-aware
    kernel receives them in that order), then scheduled with release gating.
    With all releases 0 the result equals :func:`run_fast`'s bit for bit.
    The schedule's ``pi`` is the arrival order.
    """
    inst = oinst.inst
    rel = oinst.releases
    delta_k = _normalize_delta_k(inst, delta_k)
    arrival, _ = online_orders(inst, rel)
    _, scheduling = _resolve_algorithm(algorithm, scheduling)
    table = build_flow_table(inst, arrival, algorithm, seed=seed,
                             backend=backend, delta_k=delta_k,
                             locality=locality)
    t_est, srv = _times_for_table(inst, arrival, table, scheduling,
                                  releases=rel, delta_k=delta_k)
    return _schedule_from_times(inst, arrival, table, t_est, srv,
                                _delta_f(inst, table, delta_k))


# --------------------------------------------------------------------------
# Differential gates: the engine against the reference's oracles.
# --------------------------------------------------------------------------

def _oracle_assignment(inst: Instance, pi: torch.Tensor, policy: str,
                       seed: int) -> Assignment:
    if policy == "tau-aware":
        return assign_tau_aware(inst, pi)
    if policy == "rho-only":
        return assign_rho_only(inst, pi)
    return assign_random(inst, pi, seed=seed)


#: Maximum kernel/``assign_ref`` choice-disagreement rate the kernel gate
#: accepts: the fp32 precision contract of the reference's kernel. One
#: tie-break divergence is always allowed (on a tiny instance one expected
#: flip would otherwise blow the rate); an algorithmic error lands near a
#: 1 - 1/K disagreement rate, far above this.
_PALLAS_DIVERGENCE_CEILING = 0.03


def _kernel_divergence(inst: Instance, flows: tuple[torch.Tensor, ...],
                       choices: torch.Tensor) -> tuple[int, int]:
    """``(diverged, allowed)``: how many of the kernel's ``choices`` differ
    from ``kernels.ref.assign_ref`` evaluated at the kernel's fp32-cast
    inputs (fp64 state), and the allowance ``max(1, ceil(0.03 * F))``."""
    _pos, _cid, fi, fj, sizes = flows
    ref_c, _ = assign_ref(fi.cpu().numpy(), fj.cpu().numpy(),
                          sizes.cpu().numpy().astype(np.float32),
                          inst.rates.cpu().numpy().astype(np.float32),
                          float(np.float32(inst.delta)), inst.N)
    diverged = int((choices.cpu().numpy() != ref_c.astype(np.int64)).sum())
    allowed = max(1, int(np.ceil(_PALLAS_DIVERGENCE_CEILING * ref_c.size)))
    return diverged, allowed


def _choices_of(s: Schedule, pi: torch.Tensor,
                flows: tuple[torch.Tensor, ...], what: str) -> torch.Tensor:
    """The core of each flow of ``flows`` (``extract_flows(inst, pi)``) in
    schedule ``s``: rows are keyed by ``(pos, i, j)``, one flow each."""
    if not torch.equal(s.pi, pi):
        raise AssertionError(f"engine/oracle orders differ {what}")
    pos, _cid, fi, fj, _size = flows
    N = s.inst.N
    key_s = (s.pos * N + s.fi) * N + s.fj
    key_f = (pos * N + fi) * N + fj
    order = torch.argsort(key_s)
    idx = torch.searchsorted(key_s[order], key_f).clamp_max(
        max(key_s.numel() - 1, 0))
    rows = order[idx]
    if key_s.numel() != key_f.numel() or not torch.equal(key_s[rows], key_f):
        raise AssertionError(f"engine/oracle flow sets differ {what}")
    return s.core[rows]


def _gate_choices(
    inst: Instance,
    pi: torch.Tensor,
    policy: str,
    seed: int,
    backend: str,
    fast: Schedule,
    what: str,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, Assignment | None]:
    """The assignment phase's differential gate.

    Returns ``(flows, choices, oracle assignment)``: the flows of
    ``extract_flows(inst, pi)``, their core choices, and the dataclass
    oracle's ``Assignment`` (``None`` on the kernel path).

    ``numpy`` backend: ``assign_fast``'s choices must equal the dataclass
    oracle's bit for bit, and for the tau-aware policy also
    ``kernels.ref.assign_ref``'s (three implementations in lock-step).
    ``kernel`` backend (tau-aware): the choices are the engine schedule
    ``fast``'s own, read back from its rows, so the gate adds no kernel
    launch; they are held to ``assign_ref`` at the kernel's fp32-cast
    inputs, and under the kernel's fp32 contract up to ``max(1, ceil(0.03
    * F))`` may diverge.
    """
    flows = extract_flows(inst, pi)
    if backend == "kernel" and policy == "tau-aware":
        choices = _choices_of(fast, pi, flows, what)
        diverged, allowed = _kernel_divergence(inst, flows, choices)
        if diverged > allowed:
            raise AssertionError(
                f"kernel/assign_ref diverge on {diverged}/{choices.numel()} "
                f"choices — beyond the precision-contract allowance "
                f"({allowed})")
        return flows, choices, None
    oracle_a = _oracle_assignment(inst, pi, policy, seed)
    oracle_choices = np.array(
        [af.core for per in oracle_a.flows for af in per], dtype=np.int64)
    choices = assign_fast(inst, pi, policy, seed=seed, flows=flows)
    got = choices.cpu().numpy()
    if not np.array_equal(got, oracle_choices):
        bad = int(np.argmax(got != oracle_choices))
        raise AssertionError(
            f"assign_fast/{policy} choice mismatch with the dataclass oracle "
            f"at flow {bad}: {got[bad]} vs {oracle_choices[bad]}")
    if policy == "tau-aware":
        _pos, _cid, fi, fj, sizes = flows
        ref_c, _ = assign_ref(fi.cpu().numpy(), fj.cpu().numpy(),
                              sizes.cpu().numpy(), _host_f64(inst.rates),
                              inst.delta, inst.N)
        if not np.array_equal(got, ref_c.astype(np.int64)):
            bad = int(np.argmax(got != ref_c))
            raise AssertionError(
                f"assign_fast/assign_ref choice mismatch at flow {bad}: "
                f"{got[bad]} vs {ref_c[bad]}")
    return flows, choices, oracle_a


def _assert_agree(fast: Schedule, oracle: Schedule, atol: float, what: str,
                  label: str) -> None:
    """CCTs within ``atol``, the same flow set keyed by ``(core, coflow, i,
    j, size)``, and each key's ``t_establish`` within ``atol``."""
    fc, oc = fast.ccts.cpu().numpy(), oracle.ccts.cpu().numpy()
    if not np.allclose(fc, oc, atol=atol, rtol=0.0):
        worst = int(np.argmax(np.abs(fc - oc)))
        raise AssertionError(
            f"{label} CCT mismatch {what}: coflow {worst}: "
            f"engine={fc[worst]!r} oracle={oc[worst]!r}")
    key = lambda f: (f.core, f.coflow, f.i, f.j, f.size)  # noqa: E731
    fast_t = {key(f): f.t_establish for f in scheduled_flows(fast)}
    oracle_t = {key(f): f.t_establish for f in scheduled_flows(oracle)}
    if set(fast_t) != set(oracle_t):
        raise AssertionError(f"{label} flow sets differ {what}")
    for kf, te in fast_t.items():
        if abs(te - oracle_t[kf]) > atol:
            raise AssertionError(
                f"{label} t_establish mismatch at {kf}: "
                f"{te!r} vs {oracle_t[kf]!r}")


def cross_check(
    inst: Instance,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    scheduling: str = "work-conserving",
    atol: float = 1e-6,
    fast: Schedule | None = None,
    backend: str = "numpy",
) -> Schedule:
    """Differential gate: the engine vs the reference's oracle vs the
    referee.

    Runs :func:`run_fast` (unless given its schedule ``fast`` for the same
    arguments), holds its assignment to the oracles (``_gate_choices``),
    replays the gate's assignment through the per-core oracle loops
    (``scheduler._schedule_from_assignment``, what ``scheduler.run``
    dispatches to), asserts per-coflow CCT and per-flow establishment-time
    agreement within ``atol`` (in practice exact), then runs
    ``simulator.validate`` on the engine's schedule, on its device. Returns
    the engine's schedule.

    ``backend="kernel"``: the replay schedules the engine's own kernel
    choices (the kernel's fp32 tie-breaks may differ from the fp64 oracle's),
    so the comparison isolates the scheduling phase; the only kernel launch
    is ``run_fast``'s, none when ``fast`` is given.
    """
    if fast is None:
        fast = run_fast(inst, algorithm, seed=seed, scheduling=scheduling,
                        backend=backend)
    what = f"({algorithm}, {scheduling})"
    pi = order_coflows(inst)
    policy, sched_eff = _resolve_algorithm(algorithm, scheduling)
    flows, choices, oracle_a = _gate_choices(inst, pi, policy, seed, backend,
                                             fast, what)
    percore = {
        "work-conserving": schedule_core_list,
        "priority-guard": partial(schedule_core_list, guard=True),
        "reserving": schedule_core_reserving,
        "sunflow": schedule_core_sunflow,
    }[sched_eff]
    if oracle_a is None:  # kernel path: replay the engine's own choices
        oracle_a = assignment_from_choices(inst, pi, flows, choices)
    legacy = _schedule_from_assignment(inst, pi, oracle_a, percore)
    _assert_agree(fast, legacy, atol, what, "engine/oracle")
    validate(fast)
    return fast


def cross_check_online(
    oinst: OnlineInstance,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    scheduling: str = "work-conserving",
    atol: float = 1e-6,
    fast: Schedule | None = None,
    backend: str = "numpy",
) -> Schedule:
    """Online differential gate: :func:`run_fast_online` vs the
    ``online.run_online`` oracle vs the release-respecting referee.

    The arrival-order assignment is gated as in :func:`cross_check`; the
    oracle runs through ``run_online(assignment=...)``, its scheduling
    machinery (WSPT ordering, release gating, per-core loops) in full, fed
    the gate's assignment (``backend="kernel"``: the engine's own kernel
    choices). CCTs and establishment times must agree within ``atol``, then
    ``validate(fast, releases=)`` runs on the engine's schedule. Returns the
    engine's schedule.
    """
    if fast is None:
        fast = run_fast_online(oinst, algorithm, seed=seed,
                               scheduling=scheduling, backend=backend)
    what = f"({algorithm}, {scheduling})"
    inst = oinst.inst
    arrival, _ = online_orders(inst, oinst.releases)
    policy, _sched_eff = _resolve_algorithm(algorithm, scheduling)
    flows, choices, oracle_a = _gate_choices(inst, arrival, policy, seed,
                                             backend, fast, what)
    if oracle_a is None:  # kernel path: replay the engine's own choices
        oracle_a = assignment_from_choices(inst, arrival, flows, choices)
    oracle = run_online(oinst, algorithm, seed=seed, scheduling=scheduling,
                        assignment=oracle_a)
    _assert_agree(fast, oracle, atol, what, "online engine/oracle")
    validate(fast, releases=oinst.releases)
    return fast
