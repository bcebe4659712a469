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

:func:`run_fast`, :func:`run_fast_online` and :func:`run_fast_metrics`
each make one call of :func:`_run_pipeline`, which opens the span
``fast/run`` on the process-wide tracer (``obs.trace.current_tracer()``),
with one child span a stage: ``fast/order``, ``fast/extract``,
``fast/assign``, ``fast/to_host`` (the service times and resource ids on
the device and their copies to the host), ``fast/event_loop`` (the host
loop, with its work counts ``events``, ``tested`` and ``flows``, the
compiled loop's ``visited``, ``unread`` and ``unreleased``, and its
``impl``),
``fast/to_device`` and ``fast/schedule``. With the default
``NULL_TRACER`` a stage costs one shared no-op span, and attributes are
computed only behind ``span.live``.

The event loops stay host code: sequential logic with no kernel in the
reference, where each event depends on the free times the last one wrote
and does a few comparisons and one start. The circuit event loop
(:func:`_event_loop`) runs compiled, as plain C++ built on first use by
the host compiler (``kernels/event_loop.py``, ``csrc/event_loop_host.cpp``),
in one foreign call a loop, with the semantics of the reference's
``repro.core.engine._event_loop``. The test
``tests/test_torch_event_loop_compiled.py`` holds it bit for bit to a
numpy twin of that loop, which also counts its work, and to the
reference itself. The reserving loop and sunflow's per-group glue stay
numpy. ``fast/event_loop``'s ``impl`` says which loop the stage runs:
``"compiled"``, or ``"numpy"`` for the reserving loop.

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
from functools import partial

import numpy as np
import torch

from repro_torch.kernels import event_loop as compiled_loop
from repro_torch.kernels.ops import coflow_assign
from repro_torch.kernels.ref import assign_ref
from repro_torch.obs.trace import current_tracer

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
    delta_k = _drifted_delta_k(inst, delta_k)
    policy, _ = _resolve_algorithm(algorithm, "")
    tracer = current_tracer()
    with tracer.span("fast/extract") as sp:
        flows = extract_flows(inst, pi)
        if sp.live:
            sp.set(flows=int(flows[0].shape[0]))
    pos, cid, fi, fj, size = flows
    with tracer.span("fast/assign") as sp:
        if policy == "tau-aware" and delta_k is not None:
            path = "drifted"
            st = FlatAssignState(policy, inst.rates, inst.delta, inst.N,
                                 seed=seed, locality=locality)
            for k in range(inst.K):
                if delta_k[k] != inst.delta:
                    st.set_delta(k, float(delta_k[k]))
            core = st.assign(fi, fj, size)
        elif backend == "kernel" and policy == "tau-aware" and not locality:
            path = "kernel"
            core = coflow_assign(fi, fj, size, inst.rates, inst.delta,
                                 n_ports=inst.N).to(torch.int64)
        else:
            path = "host"
            core = assign_fast(inst, pi, policy, seed=seed, flows=flows,
                               locality=locality)
        if sp.live:
            sp.set(path=path, flows=int(fi.shape[0]))
    return FlowTable(pos=pos, cid=cid, fi=fi, fj=fj, core=core, size=size)


def _drifted_delta_k(inst: Instance,
                     delta_k: torch.Tensor | np.ndarray | None,
                     ) -> np.ndarray | None:
    """A per-core delay vector as a host float64 ``(K,)`` array, or
    ``None`` where it is ``None`` or nominal on every core, so the
    undrifted pipeline keeps its exact scalar float expressions."""
    if delta_k is None:
        return None
    delta_k = _host_f64(delta_k)
    if delta_k.shape != (inst.K,):
        raise ValueError(
            f"delta_k must have shape ({inst.K},), got {delta_k.shape}")
    return None if np.all(delta_k == inst.delta) else delta_k


def _add_counts(stats: dict | None, events: int, tested: int,
                flows: int, visited: int | None = None,
                unread: int | None = None,
                unreleased: int | None = None) -> None:
    """Add an event loop's work counts to ``stats`` (when given);
    ``visited``, ``unread`` and ``unreleased`` only where the loop counts
    them (the compiled one)."""
    if stats is not None:
        for key, n in (("events", events), ("tested", tested),
                       ("flows", flows), ("visited", visited),
                       ("unread", unread), ("unreleased", unreleased)):
            if n is not None:
                stats[key] = stats.get(key, 0) + n


def _event_loop(
    rin: np.ndarray,
    rout: np.ndarray,
    srv: np.ndarray,
    core: np.ndarray,
    delta: float | np.ndarray,
    n_res: int,
    n_ports: int,
    t0: float = 0.0,
    guard: bool = False,
    release: np.ndarray | None = None,
    free_in0: np.ndarray | None = None,
    free_out0: np.ndarray | None = None,
    stats: dict | None = None,
) -> np.ndarray:
    """Merged event loop over all cores, flows in priority order,
    compiled: the arguments and the establishment times of the reference's
    ``repro.core.engine._event_loop``, bit for bit, in one call of the host
    library (``kernels/event_loop.py``), built on first use; ``t0`` is read
    as a float64. ``stats`` gets the loop's work added under ``events``
    (the times it woke at an event time, the start at ``t0`` included),
    ``tested`` (the rows whose two resources it checked, once an event
    each; under the guard, every released pending row of an active core),
    ``flows`` (the flows started), ``visited`` (the flow rows it read,
    finished ones included), ``unread`` (the rows an event left behind
    the point where it stopped reading a list) and ``unreleased`` (the
    pending rows it read and passed because their release was still
    ahead; 0 without ``release``). Raises a ``ValueError``
    for an id out of range, a NaN or a negative ``t0``."""
    t_est, counts = compiled_loop.event_loop_compiled(
        rin, rout, srv, core, delta, n_res, n_ports, t0, guard, release,
        free_in0, free_out0)
    _add_counts(stats, *counts)
    return t_est


def _reserving_times(rin: np.ndarray, rout: np.ndarray, srv: np.ndarray,
                     delta: float | np.ndarray, n_res: int,
                     release: np.ndarray | None = None,
                     avail_in: np.ndarray | None = None,
                     avail_out: np.ndarray | None = None,
                     stats: dict | None = None) -> np.ndarray:
    """Strict in-order reservation (no backfill) over merged resources.

    ``release`` (per flow) is the online variant: flows come in commitment
    (arrival) order and each reservation starts no earlier than its
    release. ``delta`` may be a per-flow array (drifted cores).

    ``avail_in``/``avail_out`` (both or neither) carry the reservation
    horizons across service ticks and are MUTATED in place: a reservation
    never moves once made, so the arrays are the committed state.
    ``stats`` gets ``events = tested = flows = F``: one reservation a flow.
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
    _add_counts(stats, rin.size, rin.size, rin.size)
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
    stats: dict | None = None,
) -> np.ndarray:
    """SUNFLOW-CORE: per core, coflows strictly one after another (a
    barrier), the flows of one coflow largest first with an ``(i, j)``
    tie-break, through the priority-guarded scan.

    ``release``/``prio`` (per flow; a coflow's flows share both) select the
    online variant: whenever the core frees, the arrived unserved coflow of
    best priority rank is served next, idling until the next arrival if
    none is pending. ``delta_k`` replaces ``delta`` core by core.
    ``stats`` gets the counts of every group's event loop added up.
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
                             guard=True, stats=stats)
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
    tracer = current_tracer()
    with tracer.span("fast/to_host"):
        srv = table.size / inst.rates[table.core]
        rin = _host(table.core * N + table.fi)
        rout = _host(table.core * N + table.fj)
        core, srv_h = _host(table.core), _host(srv)
        dl = inst.delta if delta_k is None else delta_k[core]
        if scheduling == "sunflow":
            cols = tuple(_host(t) for t in (table.pos, table.core, table.fi,
                                            table.fj, table.size))
        if releases is not None:
            rel_orig = torch.as_tensor(releases, dtype=torch.float64,
                                       device=inst.device)
            orig = pi[table.pos]
            _, prio_rank = online_orders(inst, rel_orig)
            rel_f, prio_f = _host(rel_orig[orig]), prio_rank[orig]
            if scheduling in ("work-conserving", "priority-guard"):
                # Flows in scheduling-priority order: WSPT coflow rank, then
                # the intra-coflow assignment order (stable).
                perm = _host(torch.argsort(prio_f, stable=True))
            elif scheduling == "sunflow":
                prio_h = _host(prio_f)
    with tracer.span("fast/event_loop") as sp:
        stats = dict(events=0, tested=0, flows=0) if sp.live else None
        if releases is None:
            if scheduling == "reserving":
                t_est = _reserving_times(rin, rout, srv_h, dl, K * N,
                                         stats=stats)
            elif scheduling == "sunflow":
                t_est = _sunflow_times(*cols, rin, rout, srv_h, inst.delta, N,
                                       K, delta_k=delta_k, stats=stats)
            else:
                t_est = _event_loop(rin, rout, srv_h, core, dl, K * N, N,
                                    guard=(scheduling == "priority-guard"),
                                    stats=stats)
        elif scheduling in ("work-conserving", "priority-guard"):
            te = _event_loop(rin[perm], rout[perm], srv_h[perm], core[perm],
                             dl if delta_k is None else dl[perm], K * N, N,
                             guard=(scheduling == "priority-guard"),
                             release=rel_f[perm], stats=stats)
            t_est = np.empty_like(te)
            t_est[perm] = te
        elif scheduling == "reserving":
            # commitment in arrival order, the flow table's own order
            t_est = _reserving_times(rin, rout, srv_h, dl, K * N,
                                     release=rel_f, stats=stats)
        else:
            t_est = _sunflow_times(*cols, rin, rout, srv_h, inst.delta, N, K,
                                   release=rel_f, prio=prio_h,
                                   delta_k=delta_k, stats=stats)
        if sp.live:
            sp.set(**stats, impl="numpy" if scheduling == "reserving"
                   else "compiled")
    with tracer.span("fast/to_device"):
        t_dev = torch.from_numpy(t_est).to(inst.device)
    return t_dev, srv


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
    """:func:`_drifted_delta_k`, refusing a negative delay."""
    delta_k = _drifted_delta_k(inst, delta_k)
    if delta_k is not None and (delta_k < 0).any():
        raise ValueError("drifted delta must be >= 0")
    return delta_k


def _delta_f(inst: Instance, table: FlowTable,
             delta_k: np.ndarray | None) -> torch.Tensor | None:
    if delta_k is None:
        return None
    return torch.tensor(delta_k, device=inst.device)[table.core]


def _run_pipeline(inst: Instance, algorithm: str, *,
                  releases: torch.Tensor | None, seed: int, scheduling: str,
                  backend: str, delta_k: torch.Tensor | np.ndarray | None,
                  locality: float, metrics_only: bool,
                  ) -> tuple[Schedule | torch.Tensor, int]:
    """The pipeline of :func:`run_fast` (``releases=None``, WSPT order) and
    of :func:`run_fast_online` (``releases`` ``(M,)`` float64 on the
    device, arrival order), stopped at the CCTs when ``metrics_only``:
    returns ``(schedule or ccts, n_flows)``, under one ``fast/run`` span.
    The stages are looked up as module globals at each call, since
    ``perfbench/drivers/offline.py`` and ``perfbench/control.py`` replace
    some of them on the module."""
    tracer = current_tracer()
    with tracer.span("fast/run") as sp:
        delta_k = _normalize_delta_k(inst, delta_k)
        with tracer.span("fast/order"):
            if releases is None:
                pi = order_coflows(inst)
            else:
                pi, _ = online_orders(inst, releases)
        _, scheduling = _resolve_algorithm(algorithm, scheduling)
        table = build_flow_table(inst, pi, algorithm, seed=seed,
                                 backend=backend, delta_k=delta_k,
                                 locality=locality)
        t_est, srv = _times_for_table(inst, pi, table, scheduling,
                                      releases=releases, delta_k=delta_k)
        with tracer.span("fast/schedule"):
            delta_f = _delta_f(inst, table, delta_k)
            if metrics_only:
                out = _ccts_from_times(inst, pi, table, t_est, srv, delta_f)
            else:
                out = _schedule_from_times(inst, pi, table, t_est, srv,
                                           delta_f)
        if sp.live:
            sp.set(flows=table.n_flows, coflows=inst.M, K=inst.K,
                   backend=backend, scheduling=scheduling,
                   online=releases is not None, metrics_only=metrics_only)
    return out, table.n_flows


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
    return _run_pipeline(inst, algorithm, releases=None, seed=seed,
                         scheduling=scheduling, backend=backend,
                         delta_k=delta_k, locality=locality,
                         metrics_only=False)[0]


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
    return _run_pipeline(
        inst, algorithm,
        releases=None if releases is None else torch.as_tensor(
            releases, dtype=torch.float64, device=inst.device),
        seed=seed, scheduling=scheduling, backend=backend, delta_k=delta_k,
        locality=locality, metrics_only=True)


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
    return _run_pipeline(oinst.inst, algorithm, releases=oinst.releases,
                         seed=seed, scheduling=scheduling, backend=backend,
                         delta_k=delta_k, locality=locality,
                         metrics_only=False)[0]


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
